"""VBPI training steps for the reference (Zhang and Matsen, ICLR 2019),
followed over given samples: the topologies and standard normals a step
drew are inputs here, as sampled tokens are to a model's reference.

A step over P particles (topology tau_j, normals eps_j), with the
split-lognormal branch model (a (mu, sigma) pair per split), an
exponential prior of rate 10 on each branch length, the subsplit Bayesian
network q (sbn.py) and annealing beta:

  theta_j = exp(mu + sigma eps_j), edge by edge (its split's pair);
  log f_j = beta LL(tau_j, theta_j) + log prior(theta_j)
            - log q(tau_j) - log q_branch(theta_j);
  the branch model's gradient: sum_j d/d(mu, sigma) of
            beta LL + log prior - log q_branch (reparameterised);
  the network's gradient: sum_j c_j d log q(tau_j), with VIMCO's
            leave-one-out factors c_j (Mnih and Rezende 2016: log of the
            mean of f less the mean with f_j replaced by the geometric
            mean of the others, less f_j's normalised weight);
  both ascended by Adam (b1 0.9, b2 0.999, eps 1e-8 after the root,
            bias-corrected), one state a group.

This is the estimator of vip and libsbn's vbpi step as the measured
program states it. Log-likelihoods and their branch gradients come from
likelihood.py. Plain PyTorch; no import of the measured program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from . import likelihood, sbn
from .trees import Tree

PRIOR_RATE = 10.0


class Adam:
    def __init__(self, lr: float, dtype, device, shape,
                 b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu = torch.zeros(shape, dtype=dtype, device=device)
        self.nu = torch.zeros(shape, dtype=dtype, device=device)
        self.t = 0

    def ascend(self, x, grad):
        self.t += 1
        self.mu = self.b1 * self.mu + (1 - self.b1) * grad
        self.nu = self.b2 * self.nu + (1 - self.b2) * grad * grad
        mu_hat = self.mu / (1 - self.b1 ** self.t)
        nu_hat = self.nu / (1 - self.b2 ** self.t)
        return x + self.lr * mu_hat / (torch.sqrt(nu_hat) + self.eps)


def vimco_factors(log_f):
    K = log_f.shape[0]
    log_mean = torch.logsumexp(log_f, 0) - math.log(K)
    weight = torch.exp(log_f - torch.logsumexp(log_f, 0))
    others = (log_f.sum() - log_f) / (K - 1)  # log geometric mean
    loo = torch.stack([
        torch.logsumexp(torch.cat([log_f[:j], others[j:j + 1],
                                   log_f[j + 1:]]), 0)
        for j in range(K)]) - math.log(K)
    return log_mean - weight - loo


class Trainer:
    """The state (q_params (V, 2) by the support's splits, the network's
    parameters) and its Adam states, from the configuration's start."""

    def __init__(self, support: sbn.Support, pats, q0: Sequence[float],
                 lr_scalar: float, lr_sbn: float, device="cpu",
                 control: bool = False):
        self.support, self.pats = support, pats
        self.control = control
        self.dtype = torch.float32 if control else torch.float64
        self.device = torch.device(device)
        t = dict(dtype=self.dtype, device=self.device)
        self.q = torch.tensor(np.tile(q0, (len(support.splits), 1)), **t)
        self.phi = torch.tensor(support.simple_average(), **t)
        self.adam_q = Adam(lr_scalar, self.dtype, self.device, self.q.shape)
        self.adam_phi = Adam(lr_sbn, self.dtype, self.device, self.phi.shape)
        self.split_row = {s: i for i, s in enumerate(support.splits)}
        # The largest |gradient| each entry has had, for the rule that
        # leaves out entries that only round-off moves.
        self.gmax_q = torch.zeros_like(self.q)
        self.gmax_phi = torch.zeros_like(self.phi)
        self.model = likelihood.Model("JC69", "constant", 1)

    def step(self, trees: List[Tree], eps: np.ndarray, beta: float) -> Dict:
        """One step; trees: the P sampled topologies; eps (P, E): each
        one's normals in its edge (split) order."""
        t = dict(dtype=self.dtype, device=self.device)
        P = len(trees)
        rows = torch.tensor([[self.split_row[s] for s in tr.splits]
                             for tr in trees], device=self.device)
        q = self.q.clone().requires_grad_(True)
        phi = self.phi.clone().requires_grad_(True)
        mu, sigma = q[rows, 0], q[rows, 1]
        e = torch.as_tensor(eps, **t)
        theta = torch.exp(mu + sigma * e)  # (P, E)
        ref = likelihood.evaluate(
            trees, np.arange(P), theta.detach().to("cpu", torch.float64),
            self.pats, self.model, device=self.device, control=self.control)
        ll = torch.as_tensor(ref["ll"], **t)
        g = torch.as_tensor(ref["bgrad"], **t)
        # beta LL(theta) to first order about the drawn theta: its value
        # and its gradient, which is all a step takes of it.
        ll_theta = ll + (g * (theta - theta.detach())).sum(-1)
        E = theta.shape[1]
        log_prior = E * math.log(PRIOR_RATE) - PRIOR_RATE * theta.sum(-1)
        log_theta = torch.log(theta)
        log_qb = (-log_theta - torch.log(sigma) - 0.5 * math.log(2 * math.pi)
                  - (log_theta - mu) ** 2 / (2 * sigma ** 2)).sum(-1)
        reps = torch.as_tensor(np.stack([self.support.representation(tr)
                                         for tr in trees]), device=self.device)
        log_qs = sbn.log_q(sbn.normalized_log(phi, self.support.segment,
                                              self.support.segments), reps)
        log_f = beta * ll_theta + log_prior - log_qs - log_qb
        (gq,) = torch.autograd.grad(
            (beta * ll_theta + log_prior - log_qb).sum(), q)
        c = vimco_factors(log_f.detach())
        (gphi,) = torch.autograd.grad((c * log_qs).sum(), phi)
        self.gmax_q = torch.maximum(self.gmax_q, gq.abs())
        self.gmax_phi = torch.maximum(self.gmax_phi, gphi.abs())
        self.q = self.adam_q.ascend(self.q, gq)
        self.phi = self.adam_phi.ascend(self.phi, gphi)
        return {"mean_ll": float(ll.mean()),
                "elbo_like": float(log_f.detach().mean())}
