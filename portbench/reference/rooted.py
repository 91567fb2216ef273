"""The plain reference of rooted time trees under a strict clock: Felsenstein's
pruning over a dated rooted tree whose node heights come from height
ratios, in float64, with every gradient taken by autograd.

It works out for itself what the measured program derives:

* tip dates from the taxon names (the number after the last ``_``), made
  relative to the latest tip, so that the latest has date 0 and dates grow
  into the past;
* each node's bound, the largest date of a tip below it;
* the file's tree as height ratios: heights from the branch lengths (a
  node's height is its first child's plus that child's branch), then
  r_v = (h_v - b_v) / (h_parent - b_v) at each internal non-root node,
  and the root's height;
* heights from ratios, root first: h_v = b_v + r_v (h_parent - b_v);
* branch lengths (h_parent - h_v) times the clock rate, one rate for every
  branch (a strict clock);
* JC69's transition matrices in closed form (by expm1, so that a short
  branch's off-diagonal keeps its digits), and pruning from the tips to
  the root (the root has two children), each internal node's partial
  rescaled by its largest entry, the root's frequencies 1/4;
* the log-det-Jacobian of the ratios-to-heights map, the sum over internal
  non-root nodes of log(h_parent - b_v).

It returns LL, the log-det-Jacobian, d(LL + log-det-Jacobian) / d(ratios,
root height) and d LL / d clock rate, the last two by autograd. These are
libsbn's definitions: rooted_tree.cpp (the ratio parameterisation and the
bounds), taxon_name_munging.cpp (dates from names), fat_beagle.cpp (the
Jacobian, added to the LL that is differentiated) and
rooted_gradient_transforms.cpp (the ratio and clock gradients, which
libsbn takes by the hand recursions of Ji et al. 2020; here autograd).
Departures: every computation is float64 on the given device, where libsbn
runs float64 on the CPU through BEAGLE; the rescaling is the reference's
own, which leaves the LL unchanged.

Nodes are numbered here: leaves 0..L-1 in the sorted order of their names,
internal nodes L..2L-2 in postorder (children in the file's order), the
root last. Each internal node's leaf set, a bitmask over the sorted taxa,
names it whatever numbering a program gives it. The ratios (L-1,) hold the
internal non-root nodes' ratios in that order, then the root's height.

``control=True`` computes the same in the precision below the
configuration's float32: float32 with every contraction's operands rounded
to TF32 (10 explicit mantissa bits, round to nearest even), as
reference/likelihood.py's control does. Plain PyTorch; no import of the
measured program.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from .trees import _parse

# A date is the number a taxon name ends with, after its last "_".
_DATE = re.compile(r"^.+_(\d*\.?\d+(?:[eE][-+]?\d+)?)$")
# libsbn's tolerance on a time tree's heights read from branch lengths
# (rooted_tree.cpp).
_CALIBRATION_TOLERANCE = 1e-4


@dataclass(frozen=True)
class TimeTree:
    """A dated rooted binary tree, numbered as the module says.

    parent (N - 1,): each non-root node's parent; children (L - 1, 2): each
    internal node's, row v - L for node v; masks (L - 1,): each internal
    node's leaf set; bounds (N,): each node's largest tip date below it;
    ratios (L - 1,): the file's tree as height ratios, root height last."""

    taxa: Tuple[str, ...]
    parent: np.ndarray
    children: np.ndarray
    masks: Tuple[int, ...]
    bounds: np.ndarray
    ratios: np.ndarray

    @property
    def leaf_count(self) -> int:
        return len(self.taxa)

    @property
    def node_count(self) -> int:
        return 2 * len(self.taxa) - 1


def date_of(name: str) -> float:
    m = _DATE.match(name)
    if m is None:
        raise ValueError(f"no date at the end of the taxon name {name!r}")
    return float(m.group(1))


def read_time_tree(path: str) -> TimeTree:
    """The first tree of a Newick file as a TimeTree, dated from its taxon
    names; raises unless its root has two children and its branch lengths
    put every tip at its date."""
    with open(path) as f:
        text = f.read()
    root = _parse(text[text.find("("):text.find(";") + 1], {})
    leaves: List = []

    def collect(nd):
        if not nd.children:
            leaves.append(nd)
        if nd.children and len(nd.children) != 2:
            raise ValueError("a rooted binary tree needs two children a node")
        for c in nd.children:
            collect(c)

    collect(root)
    taxa = tuple(sorted(nd.name for nd in leaves))
    L = len(taxa)
    index = {name: i for i, name in enumerate(taxa)}
    years = np.array([date_of(t) for t in taxa])
    dates = years.max() - years
    N = 2 * L - 1
    parent = np.zeros(N - 1, np.int64)
    children = np.zeros((L - 1, 2), np.int64)
    masks = [0] * (L - 1)
    length = np.zeros(N)
    counter = [L]

    def walk(nd) -> Tuple[int, int]:
        if not nd.children:
            v = index[nd.name]
            length[v] = nd.length
            return v, 1 << v
        kids = [walk(c) for c in nd.children]
        v = counter[0]
        counter[0] += 1
        for j, (k, _) in enumerate(kids):
            parent[k] = v
            children[v - L, j] = k
        masks[v - L] = kids[0][1] | kids[1][1]
        length[v] = nd.length
        return v, masks[v - L]

    walk(root)
    bounds = np.zeros(N)
    bounds[:L] = dates
    heights = np.zeros(N)
    heights[:L] = dates
    for v in range(L, N):  # postorder: children first
        c0, c1 = children[v - L]
        bounds[v] = max(bounds[c0], bounds[c1])
        heights[v] = heights[c0] + length[c0]
        if abs(heights[c1] + length[c1] - heights[v]) > _CALIBRATION_TOLERANCE:
            raise ValueError(f"{path}: the tree is not time-calibrated")
    ratios = np.zeros(L - 1)
    for v in range(L, N - 1):
        ratios[v - L] = ((heights[v] - bounds[v])
                         / (heights[parent[v]] - bounds[v]))
    ratios[-1] = heights[N - 1]
    return TimeTree(taxa, parent, children, tuple(masks), bounds, ratios)


def _tf32(x):
    """x rounded to TF32's 10 mantissa bits, to nearest even; the gradient
    passes straight through."""
    bits = x.detach().contiguous().view(torch.int32)
    rounded = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return x + (rounded.view(torch.float32) - x).detach()


def _jc69_p(t):
    """(b,) branch lengths -> (b, 4, 4) JC69 transition matrices, the
    off-diagonal -expm1(-4t/3) / 4, exact to the type's precision however
    short the branch."""
    m = -torch.expm1(-4.0 / 3.0 * t)
    same, diff = 1.0 - 0.75 * m, 0.25 * m
    eye = torch.eye(4, dtype=t.dtype, device=t.device)
    return diff[:, None, None] + (same - diff)[:, None, None] * eye


def heights_of(tree: TimeTree, ratios, bounds):
    """(b, N) node heights from ratios (b, L - 1) and bounds (N,), root
    first, differentiable in the ratios."""
    L, N = tree.leaf_count, tree.node_count
    h: List = [None] * N
    for v in range(L):
        h[v] = bounds[v].expand(ratios.shape[0])
    h[N - 1] = ratios[:, -1]
    for v in range(N - 2, L - 1, -1):  # reverse postorder: parents first
        b = bounds[v]
        h[v] = b + ratios[:, v - L] * (h[int(tree.parent[v])] - b)
    return torch.stack(h, dim=1)


def _group(tree: TimeTree, ratios, rate, tips, weights, control: bool):
    """LL, log-det-Jacobian and gradients of b trees' ratios (b, L - 1) at
    clock rates (b,)."""
    dt = torch.float32 if control else torch.float64
    L, N = tree.leaf_count, tree.node_count
    r = ratios.detach().to(dt).requires_grad_(True)
    k = rate.detach().to(dt).requires_grad_(True)
    bounds = torch.as_tensor(tree.bounds, device=r.device).to(dt)
    h = heights_of(tree, r, bounds)
    parent = torch.as_tensor(tree.parent, device=r.device)
    hp = h[:, parent]  # (b, N - 1) each node's parent's height
    P = _jc69_p(((hp - h[:, :N - 1]) * k[:, None]).reshape(-1)).view(
        r.shape[0], N - 1, 4, 4)

    def einsum(spec, *ops):
        if control:
            ops = tuple(_tf32(o) for o in ops)
        return torch.einsum(spec, *ops)

    evolved = {v: einsum("bij,pj->bpi", P[:, v], tips[v]) for v in range(L)}
    logscale = torch.zeros((r.shape[0], tips.shape[1]), dtype=dt,
                           device=r.device)
    for v in range(L, N):
        c0, c1 = tree.children[v - L]
        partial = evolved.pop(int(c0)) * evolved.pop(int(c1))
        top = partial.detach().amax(dim=2)  # (b, p)
        partial = partial / top[:, :, None]
        logscale = logscale + torch.log(top)
        if v < N - 1:
            evolved[v] = einsum("bij,bpj->bpi", P[:, v], partial)
    site = einsum("bpi,i->bp", partial,
                  torch.full((4,), 0.25, dtype=dt, device=r.device))
    ll = ((torch.log(site) + logscale) * weights).sum(-1)
    ldj = torch.log(hp[:, L:] - bounds[L:N - 1]).sum(-1)
    g_ratio, g_clock = torch.autograd.grad((ll + ldj).sum(), (r, k))
    return {"ll": ll.detach(), "ldj": ldj.detach(), "ratio": g_ratio,
            "clock": g_clock}


def evaluate(tree: TimeTree, pats, ratios, rate: float, device="cpu",
             control: bool = False, block: int = 256) -> Dict[str, np.ndarray]:
    """LL, log-det-Jacobian and gradients of a batch of the tree's ratio
    sets, float64 numpy on the host.

    pats: the alignment's patterns over ``tree.taxa`` (alignment.py);
    ratios (B, L - 1): each row's ratios in this module's order, root
    height last; rate: the strict clock's rate. Returns {"ll": (B,),
    "ldj": (B,), "ratio": (B, L - 1) d(LL + ldj) / d ratios, "clock": (B,)
    d LL / d rate}, ``block`` rows at a time."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if tuple(pats.taxa) != tree.taxa:
        raise ValueError("the patterns' taxa are not the tree's")
    dt = torch.float32 if control else torch.float64
    dev = torch.device(device)
    tips = torch.as_tensor(pats.tips, device=dev).to(dt)
    weights = torch.as_tensor(pats.weights, device=dev).to(dt)
    ratios = np.asarray(ratios, np.float64)
    out: Dict[str, List[np.ndarray]] = {}
    for s in range(0, len(ratios), block):
        r = torch.as_tensor(ratios[s:s + block], device=dev)
        k = torch.full((len(r),), float(rate), dtype=torch.float64,
                       device=dev)
        for name, v in _group(tree, r, k, tips, weights, control).items():
            out.setdefault(name, []).append(
                v.detach().to("cpu", torch.float64).numpy())
    return {k: np.concatenate(v) for k, v in out.items()}
