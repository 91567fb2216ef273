"""VBPI optimizers: first-order update rules + ELBO-feedback step-size
control (the counterpart of libsbn_tpu.vi.optimizers).

The reference ships a hand-rolled bank of first-order update rules
(vip/sgd_server.py) and two step-size controllers (vip/optimizers.py:83-127).
libsbn_tpu expresses the rules as optax gradient transformations; here each
is a plain float64 numpy function with optax's arithmetic, in optax's order
of operations (bias correction by 1 - decay**count with an integer count,
adam's eps outside the square root), over the same state, whose leaves
``GroupedAscent.state_leaves`` lists in optax's leaf order (so checkpoints
move between the two packages). These are tiny host-side updates: the
likelihood work of a step runs on the engine's device, the update on the
host, as in libsbn_tpu (which pins optax to its CPU device).

What stays domain-specific is

  * ascent (the objective is the ELBO) with independent step sizes for the
    two parameter groups (variational scalar params vs SBN params), and
  * step-size scheduling driven by ELBO feedback: decay-on-success /
    halve-on-nonfinite ("simple"), or grow-until-the-windowed-ELBO-drops,
    then restore the best parameters seen and decay ("bump").

Numeric behavior is pinned by the JAX package's golden trajectories
(tests/test_vi.py::test_optimizer_trajectory_golden, scripted gradients ->
identical parameters at 1e-12), which tests/test_torch_vi.py holds the
port to.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import numpy as np

# optax flattens a dict of groups in sorted key order.
GROUPS = ("sbn_params", "scalar_params")


class Rule(NamedTuple):
    """An update rule: the names of its per-group state slots, in optax's
    leaf order, whether the state leads with an int32 step count, and
    update(g, slots, count) -> (update, new slots) for one group, where
    count is the incremented step count."""

    slots: tuple
    counted: bool
    update: Callable


def _bias_corrected(moment, decay, count):
    return moment / (1 - decay ** count)


def _adam(b1=0.9, b2=0.999, eps=1e-8):
    """optax.scale_by_adam."""
    def update(g, st, count):
        mu = (1 - b1) * g + b1 * st["mu"]
        nu = (1 - b2) * (g * g) + b2 * st["nu"]
        u = _bias_corrected(mu, b1, count) / (
            np.sqrt(_bias_corrected(nu, b2, count)) + eps)
        return u, {"mu": mu, "nu": nu}
    return Rule(("mu", "nu"), True, update)


def _amsgrad(b1=0.9, b2=0.99, eps=1e-8):
    """optax.scale_by_amsgrad."""
    def update(g, st, count):
        mu = (1 - b1) * g + b1 * st["mu"]
        nu = (1 - b2) * (g * g) + b2 * st["nu"]
        nu_max = np.maximum(st["nu_max"], _bias_corrected(nu, b2, count))
        u = _bias_corrected(mu, b1, count) / (np.sqrt(nu_max) + eps)
        return u, {"mu": mu, "nu": nu, "nu_max": nu_max}
    return Rule(("mu", "nu", "nu_max"), True, update)


def _rms(decay=0.9, eps=1e-8):
    """optax.scale_by_rms (eps inside the square root, no bias
    correction)."""
    def update(g, st, count):
        nu = (1 - decay) * (g * g) + decay * st["nu"]
        return (1 / np.sqrt(nu + eps)) * g, {"nu": nu}
    return Rule(("nu",), False, update)


def _rss(eps=1e-7):
    """optax.scale_by_rss(initial_accumulator_value=0.0)."""
    def update(g, st, count):
        sos = g * g + st["sum_of_squares"]
        with np.errstate(divide="ignore"):
            inv = np.where(sos > 0, 1 / np.sqrt(sos + eps), 0.0)
        return inv * g, {"sum_of_squares": sos}
    return Rule(("sum_of_squares",), False, update)


def _adadelta(rho=0.9, eps=1e-8):
    """optax.scale_by_adadelta."""
    def update(g, st, count):
        e_g = (1 - rho) * (g * g) + rho * st["e_g"]
        u = (np.sqrt(st["e_x"] + eps) / np.sqrt(e_g + eps)) * g
        e_x = (1 - rho) * (u * u) + rho * st["e_x"]
        return u, {"e_g": e_g, "e_x": e_x}
    return Rule(("e_g", "e_x"), False, update)


def _trace(decay=0.9):
    """optax.trace (heavy-ball momentum)."""
    def update(g, st, count):
        trace = g + decay * st["trace"]
        return trace, {"trace": trace}
    return Rule(("trace",), False, update)


# Update rules, capability parity with the reference's SGD_Server zoo and
# libsbn_tpu's optax RULES (same names, same hyperparameters). Only "adam"
# (the one the reference training loop actually uses) is pinned by golden
# trajectories.
RULES: Dict[str, Callable[[], Rule]] = {
    "adam": _adam,
    "amsgrad": _amsgrad,
    "rmsprop": _rms,
    "adagrad": _rss,
    "adadelta": _adadelta,
    "sgd": _trace,
}


class GroupedAscent:
    """One update rule over a dict of parameter groups, with per-group step
    sizes applied outside the rule (they change every step under the
    controllers below)."""

    def __init__(self, example_params: Dict[str, np.ndarray],
                 rule: str = "adam"):
        self._rule = RULES[rule]()
        self.count = np.zeros((), np.int32)
        self.state = {
            slot: {k: np.zeros_like(np.asarray(example_params[k],
                                               dtype=np.float64))
                   for k in GROUPS}
            for slot in self._rule.slots
        }

    def ascent_updates(self, grads, params, step_sizes):
        """Transformed-gradient ascent deltas, scaled per group."""
        count = self.count
        if self._rule.counted:
            count = np.minimum(count + 1, np.iinfo(np.int32).max).astype(
                np.int32)
        out = {}
        for k in GROUPS:
            u, new = self._rule.update(
                np.asarray(grads[k], dtype=np.float64),
                {slot: self.state[slot][k] for slot in self._rule.slots},
                int(count))
            for slot, value in new.items():
                self.state[slot][k] = value
            out[k] = step_sizes[k] * u
        self.count = count
        return out

    # -- checkpoint support ------------------------------------------------
    def state_leaves(self):
        """The state as optax's leaves: the count (int32, counted rules
        only), then each slot's groups in sorted key order."""
        leaves = [np.asarray(self.count)] if self._rule.counted else []
        return leaves + [self.state[slot][k] for slot in self._rule.slots
                         for k in GROUPS]

    def load_state_leaves(self, leaves):
        leaves = list(leaves)
        if self._rule.counted:
            self.count = np.asarray(leaves.pop(0), np.int32)
        for slot in self._rule.slots:
            for k in GROUPS:
                self.state[slot][k] = np.asarray(leaves.pop(0), np.float64)


class BaseOptimizer:
    """Shared plumbing: holds the instance + scalar model whose parameters
    are updated in place, and delegates the post-step step-size policy to
    `update()` in subclasses."""

    def __init__(self, inst, scalar_model, elbo_estimator_fn: Callable):
        self.inst = inst
        self.scalar_model = scalar_model
        self.estimate_elbo = elbo_estimator_fn
        self.trace = []
        self.step_number = 0
        self.step_size = scalar_model.suggested_step_size()
        self.sbn_step_size = 0.001
        self.ascent = GroupedAscent(
            {
                "scalar_params": scalar_model.q_params,
                "sbn_params": np.asarray(inst.sbn_parameters),
            }
        )

    def _apply(self, grad_dict) -> bool:
        """One ascent step; False (and no state change) on non-finite scalar
        gradients so the controller can react."""
        if self.scalar_model.q_params.shape != grad_dict["scalar_params"].shape:
            raise ValueError("scalar gradient shape does not match q_params")
        if not np.isfinite(grad_dict["scalar_params"]).all():
            return False
        deltas = self.ascent.ascent_updates(
            grad_dict,
            {
                "scalar_params": self.scalar_model.q_params,
                "sbn_params": np.asarray(self.inst.sbn_parameters),
            },
            {"scalar_params": self.step_size, "sbn_params": self.sbn_step_size},
        )
        self.scalar_model.q_params += deltas["scalar_params"]
        self.inst.sbn_parameters = (
            np.asarray(self.inst.sbn_parameters) + deltas["sbn_params"]
        )
        return True

    def gradient_step(self, grad_dict):
        self.update(self._apply(grad_dict))

    def update(self, gradient_step_was_successful: bool):
        raise NotImplementedError


class SimpleOptimizer(BaseOptimizer):
    """Geometric step-size decay; halve on a failed (non-finite) step."""

    DECAY = 1 - 1e-2

    def update(self, ok: bool):
        if ok:
            self.step_size *= self.DECAY
        else:
            self.step_size /= 2
        self.step_number += 1


class BumpStepsizeOptimizer(BaseOptimizer):
    """Two-phase schedule: grow the step size by 1.2x per step while the
    ELBO (mean over a 5-step window, estimated at 500 particles) keeps
    improving; on the first windowed drop or non-finite gradient, restore
    the best q_params seen, cut the step size 4x, and decay from there."""

    WINDOW = 5
    GROW = 1.2
    DECAY = 1 - 1e-2
    DROP_FROM_PEAK = 4

    def __init__(self, inst, scalar_model, elbo_estimator_fn):
        super().__init__(inst, scalar_model, elbo_estimator_fn)
        self.stepsize_increasing = True
        self.best_elbo = -np.inf
        self.best_q_params = np.zeros(scalar_model.q_params.shape)

    def _window_dropped(self) -> bool:
        if self.step_number < 2 * self.WINDOW:
            return False
        last = np.mean(self.trace[-self.WINDOW:])
        prev = np.mean(self.trace[-2 * self.WINDOW: -self.WINDOW])
        return last < prev

    def _restore_best_and_drop(self):
        np.copyto(self.scalar_model.q_params, self.best_q_params)
        self.step_size /= self.DROP_FROM_PEAK
        self.stepsize_increasing = False

    def update(self, ok: bool):
        if not ok or (self.stepsize_increasing and self._window_dropped()):
            self._restore_best_and_drop()
        self.step_size *= self.GROW if self.stepsize_increasing else self.DECAY
        self.trace.append(self.estimate_elbo(particle_count=500))
        if self.trace[-1] > self.best_elbo:
            self.best_elbo = self.trace[-1]
            np.copyto(self.best_q_params, self.scalar_model.q_params)
        self.step_number += 1
        return np.isfinite(self.trace[-1])


def of_name(name: str, inst, scalar_model, elbo_estimator_fn) -> BaseOptimizer:
    choices = {"simple": SimpleOptimizer, "bump": BumpStepsizeOptimizer}
    if name not in choices:
        raise ValueError(f"Optimizer {name} not known.")
    return choices[name](inst, scalar_model, elbo_estimator_fn)
