"""Dict-keyed stochastic-gradient optimizer bank (vip/sgd_server.py parity).

A copy of libsbn_tpu.vi.sgd_server, numpy on the host. The reference's
``SGD_Server`` exposes six update rules over a dict of named parameter
groups, each with its own step size; the production training loop uses
only adam (vip/optimizers.py:42-51), which vi/optimizers.py computes
(golden-trajectory-pinned). This module keeps the
full bank available as public API for users migrating code that calls the
other rules directly. Formulas are the standard ones, with the reference's
conventions: ``decay`` acts as L2 shrinkage folded into the gradient, and
rmsprop/adagrad/adadelta place eps inside the square root
(vip/sgd_server.py:91-131).

Every method returns the UPDATE dict (to be added to the parameters by the
caller), exactly as the reference does.

Deliberate deviation: the reference's constructor ignores its ``gamma``
argument and hardcodes 0.9 (vip/sgd_server.py:33 reassigns
``self.gamma = 0.9``); here the argument is honored. Default calls are
identical.
"""

from typing import Dict

import numpy as np


class SGD_Server:  # noqa: N801 - reference-exact class name
    def __init__(
        self,
        dim_dict: Dict[str, object],
        beta_0: float = 0.9,
        beta_1: float = 0.999,
        beta_1_ams: float = 0.99,
        gamma: float = 0.9,
        epsilon: float = 1e-08,
        decay: float = 0.0,
        momentum: float = 0.9,
    ):
        self.beta_0 = beta_0
        self.beta_1 = beta_1
        self.beta_1_ams = beta_1_ams
        self.gamma = gamma
        self.mom = momentum
        self.decay = decay
        self.eps = epsilon
        self.vars = list(dim_dict.keys())
        # First/second-moment accumulators per parameter group, plus the
        # amsgrad running max and the adadelta squared-update average.
        self.mean_grad = {k: np.zeros(d) for k, d in dim_dict.items()}
        self.var_grad = {k: np.zeros(d) for k, d in dim_dict.items()}
        self.var_delta = {k: np.zeros(d) for k, d in dim_dict.items()}
        self.var_grad_max = {k: np.zeros(d) for k, d in dim_dict.items()}
        self.t = 0

    def _decayed(self, param_dict, grad_dict):
        return {
            k: np.asarray(grad_dict[k]) - self.decay * np.asarray(param_dict[k])
            for k in self.vars
        }

    def sgd(self, stepsz_dict, param_dict, grad_dict):
        g = self._decayed(param_dict, grad_dict)
        for k in self.vars:
            self.mean_grad[k] = self.mom * self.mean_grad[k] + stepsz_dict[k] * g[k]
        return self.mean_grad

    def adam(self, stepsz_dict, param_dict, grad_dict):
        g = self._decayed(param_dict, grad_dict)
        self.t += 1
        bc0 = 1.0 - self.beta_0 ** self.t
        bc1 = 1.0 - self.beta_1 ** self.t
        out = {}
        for k in self.vars:
            self.mean_grad[k] = (
                self.beta_0 * self.mean_grad[k] + (1.0 - self.beta_0) * g[k]
            )
            self.var_grad[k] = (
                self.beta_1 * self.var_grad[k] + (1.0 - self.beta_1) * g[k] ** 2
            )
            out[k] = stepsz_dict[k] * (self.mean_grad[k] / bc0) / (
                np.sqrt(self.var_grad[k] / bc1) + self.eps
            )
        return out

    def amsgrad(self, stepsz_dict, param_dict, grad_dict):
        g = self._decayed(param_dict, grad_dict)
        self.t += 1
        bc0 = 1.0 - self.beta_0 ** self.t
        bc1 = 1.0 - self.beta_1_ams ** self.t
        out = {}
        for k in self.vars:
            self.mean_grad[k] = (
                self.beta_0 * self.mean_grad[k] + (1.0 - self.beta_0) * g[k]
            )
            self.var_grad[k] = (
                self.beta_1_ams * self.var_grad[k]
                + (1.0 - self.beta_1_ams) * g[k] ** 2
            )
            self.var_grad_max[k] = np.maximum(self.var_grad_max[k], self.var_grad[k])
            out[k] = stepsz_dict[k] * (self.mean_grad[k] / bc0) / (
                np.sqrt(self.var_grad_max[k] / bc1) + self.eps
            )
        return out

    def rmsprop(self, stepsz_dict, param_dict, grad_dict):
        g = self._decayed(param_dict, grad_dict)
        out = {}
        for k in self.vars:
            self.var_grad[k] = (
                self.gamma * self.var_grad[k] + (1.0 - self.gamma) * g[k] ** 2
            )
            out[k] = stepsz_dict[k] * g[k] / np.sqrt(self.var_grad[k] + self.eps)
        return out

    def adagrad(self, stepsz_dict, param_dict, grad_dict):
        g = self._decayed(param_dict, grad_dict)
        out = {}
        for k in self.vars:
            self.var_grad[k] = self.var_grad[k] + g[k] ** 2
            out[k] = stepsz_dict[k] * g[k] / np.sqrt(self.var_grad[k] + self.eps)
        return out

    def adadelta(self, stepsz_dict, param_dict, grad_dict):
        g = self._decayed(param_dict, grad_dict)
        out = {}
        for k in self.vars:
            self.var_grad[k] = (
                self.gamma * self.var_grad[k] + (1.0 - self.gamma) * g[k] ** 2
            )
            out[k] = (
                np.sqrt((self.var_delta[k] + self.eps) / (self.var_grad[k] + self.eps))
                * g[k]
            )
            self.var_delta[k] = (
                self.gamma * self.var_delta[k] + (1.0 - self.gamma) * out[k] ** 2
            )
        return out
