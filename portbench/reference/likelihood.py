"""The plain reference: Felsenstein's pruning over each tree, in float64,
with every gradient taken by autograd.

It works out for itself what the measured program derives: the tree's
traversal from the file (trees.py), the site patterns (alignment.py), the
GTR rate matrix and its exponential (``torch.linalg.matrix_exp``, not an
eigensystem), the discretised Weibull rates and the stick-breaking
transform in whose coordinates the substitution gradient is reported. The
models follow libsbn's definitions: substitution_model.cpp (a GTR Q scaled
to one expected substitution a unit of time), site_model.cpp (the median
discretisation of a Weibull of scale 1, rates scaled to mean 1, equal
weights) and stick_breaking_transform.cpp (Stan's convention).

``control=True`` computes the same in the precision below the
configurations' float32: float32 with every contraction's operands rounded
to TF32 (10 explicit mantissa bits, round to nearest even), as a TF32
matrix unit would take them. Plain PyTorch; no import of the measured
program.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .trees import Tree


@dataclass(frozen=True)
class Model:
    substitution: str  # "JC69" or "GTR"
    site: str  # "constant" or "weibull"
    categories: int = 1
    gtr_rates: Optional[Sequence[float]] = None  # AC, AG, AT, CG, CT, GT
    frequencies: Optional[Sequence[float]] = None  # A, C, G, T
    shape: Optional[float] = None

    @staticmethod
    def of_config(cfg: Dict) -> "Model":
        m = cfg["model"]
        return Model(m["substitution"], m["site"], int(m["categories"]),
                     m.get("gtr_rates"), m.get("frequencies"),
                     m.get("weibull_shape"))


def _offsets(n, like):
    return torch.log(torch.arange(n, 0, -1, dtype=like.dtype,
                                  device=like.device))


def stick_breaking(y):
    """y (..., n) unconstrained -> x (..., n + 1) on the simplex."""
    z = torch.sigmoid(y - _offsets(y.shape[-1], y))
    parts, rest = [], torch.ones_like(z[..., 0])
    for k in range(z.shape[-1]):
        parts.append(z[..., k] * rest)
        rest = rest * (1.0 - z[..., k])
    parts.append(rest)
    return torch.stack(parts, dim=-1)


def stick_breaking_inverse(x):
    """x (..., n + 1) on the simplex -> y (..., n)."""
    used = torch.cumsum(x, dim=-1)[..., :-1]
    remaining = torch.cat([torch.ones_like(used[..., :1]),
                           1.0 - used[..., :-1]], dim=-1)
    z = x[..., :-1] / remaining
    return torch.log(z) - torch.log1p(-z) + _offsets(z.shape[-1], z)


def gtr_q(rates, freqs):
    """rates (..., 6), freqs (..., 4) -> Q (..., 4, 4), one expected
    substitution a unit of time."""
    rows, cols = torch.triu_indices(4, 4, 1, device=rates.device)
    S = torch.zeros(rates.shape[:-1] + (4, 4), dtype=rates.dtype,
                    device=rates.device)
    S[..., rows, cols] = rates
    S = S + S.transpose(-1, -2)
    off = S * freqs[..., None, :]
    out_rate = off.sum(-1)
    Q = off - torch.diag_embed(out_rate)
    return Q / (out_rate * freqs).sum(-1)[..., None, None]


def weibull_rates(shape, K):
    """shape (...,) -> (..., K) category rates of mean 1: the median of
    each of K equal-probability bins of a Weibull of scale 1."""
    q = (2.0 * torch.arange(K, dtype=shape.dtype, device=shape.device)
         + 1.0) / (2.0 * K)
    raw = (-torch.log1p(-q)) ** (1.0 / shape[..., None])
    return raw / raw.mean(-1, keepdim=True)


def _tf32(x):
    """x rounded to TF32's 10 mantissa bits, to nearest even; the gradient
    passes straight through."""
    bits = x.detach().contiguous().view(torch.int32)
    rounded = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return x + (rounded.view(torch.float32) - x).detach()


class _Arith:
    """The working precision: float64, or the control's float32 with TF32
    contractions."""

    def __init__(self, control: bool):
        self.control = control
        self.dtype = torch.float32 if control else torch.float64

    def einsum(self, spec, *ops):
        if self.control:
            ops = tuple(_tf32(o.to(torch.float32)) for o in ops)
        return torch.einsum(spec, *ops)


def _jc69_p(t):
    e = torch.exp(-4.0 / 3.0 * t)
    same, diff = 0.25 + 0.75 * e, 0.25 - 0.25 * e
    eye = torch.eye(4, dtype=t.dtype, device=t.device)
    return diff[..., None, None] + (same - diff)[..., None, None] * eye


def _group(tree: Tree, lengths, tips, weights, model: Model, want_model,
           ar: _Arith, params):
    """LLs and gradients of b trees of one topology. lengths (b, E)."""
    b, dev = lengths.shape[0], lengths.device
    f64 = torch.float64
    t = lengths.detach().clone().requires_grad_(True)
    inputs = [t]
    K = model.categories
    if model.substitution == "GTR":
        y0 = torch.cat([stick_breaking_inverse(params["rates"]),
                        stick_breaking_inverse(params["freqs"])])
        y = y0.expand(b, 8).clone()
        if want_model:
            y.requires_grad_(True)
            inputs.append(y)
        freqs = stick_breaking(y[:, 5:])
        Q = gtr_q(stick_breaking(y[:, :5]), freqs)
    else:
        freqs = torch.full((b, 4), 0.25, dtype=f64, device=dev)
        Q = None
    if model.site == "weibull":
        shape = params["shape"].expand(b).clone()
        if want_model:
            shape.requires_grad_(True)
            inputs.append(shape)
        rates = weibull_rates(shape, K)
    else:
        rates = torch.ones((b, K), dtype=f64, device=dev)
    props = torch.full((K,), 1.0 / K, dtype=f64, device=dev)

    scaled = t[:, :, None] * rates[:, None, :]  # (b, E, K)
    if Q is None:
        P = _jc69_p(scaled)
    else:
        P = torch.linalg.matrix_exp(Q[:, None, None] * scaled[..., None, None])
    P = P.to(ar.dtype)  # (b, E, K, 4, 4)
    n = len(tree.taxa)
    evolved = {}
    logscale = torch.zeros((b, tips.shape[1]), dtype=ar.dtype, device=dev)

    def up(v, partial):
        Pv = P[:, tree.edge_of[v]]
        if v < n:
            return ar.einsum("bkij,pj->bkpi", Pv, partial)
        return ar.einsum("bkij,bkpj->bkpi", Pv, partial)

    for v in range(n):
        evolved[v] = up(v, tips[v])
    partial = None
    for v, kids in tree.post:
        partial = evolved.pop(kids[0])
        for c in kids[1:]:
            partial = partial * evolved.pop(c)
        top = partial.detach().amax(dim=(1, 3))  # (b, p)
        partial = partial / top[:, None, :, None]
        logscale = logscale + torch.log(top)
        if v != tree.root:
            evolved[v] = up(v, partial)
    site = ar.einsum("bkpi,bi,k->bp", partial, freqs.to(ar.dtype),
                     props.to(ar.dtype))
    lls = ((torch.log(site) + logscale) * weights.to(ar.dtype)).sum(-1)
    grads = torch.autograd.grad(lls.sum(), inputs)
    out = {"ll": lls.detach(), "bgrad": grads[0]}
    if want_model and model.substitution == "GTR":
        out["subst"] = grads[1]
    if want_model and model.site == "weibull":
        out["shape"] = grads[-1]
    return out


def evaluate(trees: Sequence[Tree], tree_index, lengths, pats, model: Model,
             want_model: bool = False, device="cpu", control: bool = False,
             block: int = 256) -> Dict[str, np.ndarray]:
    """LLs and gradients of a batch of trees, float64 numpy on the host.

    trees: the file's trees; tree_index (B,): the file tree of each row;
    lengths (B, E): each row's edge lengths in its tree's split order.
    Returns {"ll": (B,), "bgrad": (B, E)}, and with want_model
    "subst" (B, 8) (GTR's rates then frequencies, in stick-breaking
    coordinates) and "shape" (B,) (Weibull) where the model has them.
    Rows of one topology are evaluated together, ``block`` at a time."""
    ar = _Arith(control)
    dev = torch.device(device)
    f64 = torch.float64
    tips = torch.as_tensor(pats.tips, dtype=f64, device=dev).to(ar.dtype)
    weights = torch.as_tensor(pats.weights, dtype=f64, device=dev)
    params = {}
    if model.substitution == "GTR":
        params["rates"] = torch.tensor(model.gtr_rates, dtype=f64, device=dev)
        params["freqs"] = torch.tensor(model.frequencies, dtype=f64,
                                       device=dev)
    if model.site == "weibull":
        params["shape"] = torch.tensor(float(model.shape), dtype=f64,
                                       device=dev)
    tree_index = np.asarray(tree_index)
    lengths = np.asarray(lengths, np.float64)
    B = len(tree_index)
    out: Dict[str, np.ndarray] = {}
    for ti in np.unique(tree_index):
        rows_all = np.nonzero(tree_index == ti)[0]
        for s in range(0, len(rows_all), block):
            rows = rows_all[s:s + block]
            t = torch.as_tensor(lengths[rows], device=dev)
            got = _group(trees[ti], t, tips, weights, model, want_model, ar,
                         params)
            for k, v in got.items():
                v = v.detach().to("cpu", f64).numpy()
                if k not in out:
                    out[k] = np.zeros((B,) + v.shape[1:])
                out[k][rows] = v
    return out
