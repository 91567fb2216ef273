"""The on-card parity tier: golden numbers asserted on the production
configuration, the counterpart of the JAX package's tools/tpu_parity.py.

Production here is float32, the hand-written kernels and, on a card, the
engines' CUDA graphs: each engine call below runs twice, so that on a card
the first runs eagerly and the second is the captured graph's replay
(utils/graphs.py), and a check's error is the larger of the two. On the
CPU the same calls run the kernels' plain PyTorch twins. The checks, each
at tools/tpu_parity.py's tolerance:

  * DS1 (DS1.subsampled_10, JC69): ``branch_gradients`` (K1), its LLs
    against pybeagle and the last tree's sorted branch gradient against
    physher; Weibull+4 at shape 0.1, ``log_likelihoods`` (K2) against
    physher (bench.py's gate);
  * fluA rooted, strict clock at 0.001: ``rooted_log_likelihoods`` (K2) LL
    and log-det-Jacobian, ``rooted_phylo_gradients`` by the hand route (K1)
    against physher's 68 ratio and root-height gradients; GTR (the autograd
    route, K5 + K6), its LL and 8 stick-space substitution gradients
    against phylotorch; JC69 + Weibull+4 (K2 + K3) at shape 0.1, LL and
    shape gradient (src/rooted_sbn_instance.hpp:246-378);
  * GP: hello's fixed-branch marginal (K7; gp_doctest.cpp:89-101) and
    five_taxon's converged ``run_branch_ascent(1e-4, 100)`` marginal by the
    kernel route (K7 + K8) and by the level route;
  * VBPI: one ``JitVBPI(particle_count=4, seed=0).step(beta=0.5)`` on hello
    (K1), mean_ll and elbo_like against the CPU float64 step's;
  * config 2's model (GTR + Weibull+4 at shape 0.7, DS1.100_topologies):
    ``phylo_gradients`` (K4, then K5 + K6) against libsbn_tpu's float64
    scan engine's values (tests/test_torch_generic.py holds the port's
    float64 engine to that engine), so that K4 is on a parity path too.

    python -m libsbn_tpu_torch.utils.parity [--record] [--device cpu]

Runs on the card unless given ``--device cpu``. Prints one line a check
(ok or FAIL, its largest absolute error and its bound) and exits non-zero
if one fails; ``--record`` prints the same and exits 0. ``run`` returns the
checks for callers in the same process (chip_smoke.py phase [17]). This
module is the home of the golden numbers the port's scripts share.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import NamedTuple

import numpy as np
import torch

from .. import PhyloModelSpec, RootedInstance, UnrootedInstance
from ..gp import GPInstance
from ..models.phylo_model import default_parameters
from ..utils.device import DEFAULT_DEVICE, compute_device

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "data")

# DS1.subsampled_10 (the reference's unrooted_sbn_instance.hpp tests, as
# bench.py pins them): JC69 LLs (pybeagle), the last tree's branch gradient
# sorted with two zeros (physher), Weibull+4 LLs at shape 0.1 (physher).
PYBEAGLE_LIKELIHOODS = np.array([
    -14582.995273982739, -6911.294207416366, -6916.880235529542,
    -6904.016888831189, -6915.055570693576, -6915.50496696512,
    -6910.958836661867, -6909.02639968063, -6912.967861935749,
    -6910.7871105783515,
])
PHYSHER_GRADIENTS = np.array([
    -904.18956, -607.70500, -562.36274, -553.63315, -542.26058, -539.64210,
    -463.36511, -445.32555, -414.27197, -412.84218, -399.15359, -342.68038,
    -306.23644, -277.05392, -258.73681, -175.07391, -171.59627, -168.57646,
    -150.57623, -145.38176, -115.15798, -94.86412, -83.02880, -80.09165,
    -69.00574, -51.93337, 0.00000, 0.00000, 16.17497, 20.47784,
    58.06984, 131.18998, 137.10799, 225.73617, 233.92172, 253.49785,
    255.52967, 259.90378, 394.00504, 394.96619, 396.98933, 429.83873,
    450.71566, 462.75827, 471.57364, 472.83161, 514.59289, 650.72575,
    888.87834, 913.96566, 927.14730, 959.10746, 2296.55028,
])
PHYSHER_WEIBULL_LIKELIHOODS = np.array([
    -9456.1201098061, -6624.4110704332, -6623.4474776131, -6617.25658038029,
    -6627.5385571548, -6621.6155048722, -6622.3314942713, -6618.7695717585,
    -6616.3837517370, -6623.8295828648,
])
DS1_WEIBULL_SHAPE = 0.1

# fluA's dated tree at a strict clock of CLOCK_RATE (the reference's
# rooted_sbn_instance.hpp tests, as the JAX package's
# tests/test_rooted_likelihood.py pins them): physher's LL, log-det-
# Jacobian and ratio and root-height gradients; phylotorch's GTR LL and
# stick-space substitution gradient; the Weibull+4 LL and shape gradient.
CLOCK_RATE = 0.001
PHYSHER_LL = -4777.616349
PHYSHER_JACOBIAN = -9.25135166
PHYSHER_RATIO_GRADIENTS = np.array([
    -0.593654, 6.441290, 11.202945, 5.173924, -0.904631, 2.731402, 3.157131,
    7.082914, 10.305417, 13.988206, 20.709336, 48.897993, 99.164949, 130.205747,
    17.314019, 21.033290, -1.336335, 12.259822, 22.887291, 27.176564, 47.487426,
    3.637276, 12.955169, 15.315953, 83.254605, -3.806996, 105.385095, 4.874023,
    22.754466, 6.036534, 25.651478, 29.535185, 29.598789, 1.817247, 10.598685,
    76.259248, 56.481423, 10.679778, 6.587179, 3.330556, -4.622247, 33.417304,
    63.415767, 188.809515, 23.540875, 17.421076, 1.222568, 22.372012, 34.239511,
    3.486115, 4.098873, 13.200954, 19.726890, 96.808738, 4.240029, 7.414585,
    48.871694, 3.488516, 82.969065, 9.009334, 8.032474, 3.981016, 6.543650,
    53.702423, 37.835952, 2.840831, 7.517186, 19.936861,
])
ROOTED_GTR_RATES = [0.05, 0.1, 0.15, 0.20, 0.25, 0.25]
ROOTED_GTR_FREQS = [0.1, 0.2, 0.3, 0.4]
ROOTED_GTR_LL = -5221.438941335706
ROOTED_GTR_GRADIENTS = np.array([
    49.06451538, 151.83105912, 26.40235659, -8.25135661,
    75.29759338, 352.56545247, 90.07046995, 30.12301652,
])
ROOTED_WEIBULL_SHAPE = 0.1
ROOTED_WEIBULL_LL = -4618.2062529058
ROOTED_WEIBULL_SHAPE_GRADIENT = -5.231329

# Generalized pruning: hello's fixed-branch marginal (gp_doctest.cpp:89-101)
# at GP_HELLO_BL, and five_taxon's marginal after run_branch_ascent(1e-4,
# 100), brute-force pinned by the JAX package on the CPU in float64
# (tools/tpu_parity.py).
GP_HELLO = -84.77961943
GP_HELLO_BL = [0.0, 0.22, 0.113, 0.15, 0.1]
GP_FIVE_TAXON = -16.798360173496032

# One VBPI step on hello (hello_out.t after process_loaded_trees and
# train_simple_average, JC69, 4 particles, seed 0, beta 0.5) on the CPU in
# float64 (tools/tpu_parity.py; both packages draw the same host samples).
VBPI_PARTICLES = 4
VBPI_SEED = 0
VBPI_BETA = 0.5
VBPI_MEAN_LL = -82.68780605238332
VBPI_ELBO_LIKE = -42.72656590920793

# GTR + Weibull+4 on DS1.100_topologies at GTR_RATES, GTR_FREQS and
# GTR_SHAPE, from libsbn_tpu's float64 scan engine on the CPU
# (tests/test_torch_generic.py holds these to it): the 100 LLs, d LL / d b of
# edge 0, and for the first 10 trees the stick-space substitution gradients
# and d LL / d shape.
GTR_RATES = [0.1, 0.2, 0.15, 0.25, 0.2, 0.1]
GTR_FREQS = [0.3, 0.25, 0.2, 0.25]
GTR_SHAPE = 0.7
GTR_LIKELIHOODS = np.array([
    -12063.247826462177, -12063.247826462177, -12065.064513915742,
    -12066.546341549118, -12064.958601409962, -12065.064513915742,
    -12062.879578895094, -12062.284346448128, -12062.284346448128,
    -12060.47329032368, -12066.77519836391, -12062.284346448128,
    -12065.064513915742, -12076.870100388702, -12085.596890937984,
    -12080.92295259792, -12083.87257062936, -12060.47329032368,
    -12066.77519836391, -12063.247826462177, -12067.147599348833,
    -12065.064513915742, -12079.1032081323, -12062.284346448128,
    -12062.628902482365, -12063.247826462177, -12066.77519836391,
    -12060.47329032368, -12087.909802356662, -12078.607620585313,
    -12080.822526732103, -12084.464948586728, -12068.253503456332,
    -12063.247826462177, -12069.409200239426, -12066.77519836391,
    -12064.710907940189, -12063.247826462177, -12062.284346448128,
    -12066.902479326693, -12069.518578088015, -12065.934907221339,
    -12076.422682685921, -12065.064513915742, -12063.247826462177,
    -12064.521368624752, -12063.247826462177, -12071.220025238868,
    -12065.064513915742, -12065.064513915742, -12064.958601409962,
    -12064.958601409962, -12060.47329032368, -12078.186574734047,
    -12062.879578895094, -12063.247826462177, -12072.600103865445,
    -12061.196581895885, -12066.332824568493, -12065.064513915742,
    -12065.45512492349, -12065.064513915742, -12063.247826462177,
    -12065.064513915742, -12063.247826462177, -12067.936598736895,
    -12063.247826462177, -12064.958601409962, -12066.77519836391,
    -12073.94734520236, -12065.064513915742, -12063.247826462177,
    -12066.77519836391, -12063.247826462177, -12070.48361661324,
    -12060.47329032368, -12062.284346448128, -12063.247826462177,
    -12065.064513915742, -12067.750930021426, -12068.379229876662,
    -12066.035034149578, -12069.141211463775, -12072.344945426476,
    -12060.47329032368, -12065.064513915742, -12072.79874688384,
    -12063.247826462177, -12065.064513915742, -12069.518578088011,
    -12064.719173025587, -12061.196581895882, -12065.064513915742,
    -12063.247826462177, -12066.332824568493, -12062.628902482365,
    -12063.247826462177, -12063.247826462177, -12080.92295259792,
    -12083.33480917808,
])
GTR_GRADIENTS_BL0 = np.array([
    -61.43698942053795, -61.43698942053795, -61.42712196900927,
    -61.58774150418649, -61.68168873221416, -61.42712196900927,
    -61.50038687407986, -61.52313959799515, -61.52313959799515,
    -61.52669684551009, -61.67216012223884, -61.52313959799515,
    -61.42712196900927, -61.446847770590466, -61.275701747263845,
    -61.21170474051353, -61.204171743211006, -61.52669684551009,
    -61.67216012223884, -61.43698942053795, -61.67145528794126,
    -61.42712196900927, -61.222448969056316, -61.52313959799515,
    -61.45029766125027, -61.43698942053795, -61.67216012223884,
    -61.52669684551009, -61.99210816751229, -61.467566160141715,
    -61.3645395873349, -61.368161176063815, -61.4246422545573,
    -61.43698942053795, -61.61665922527933, -61.67216012223884,
    -61.77032323016345, -61.43698942053795, -61.52313959799515,
    -61.584958181638356, -61.34825866520155, -61.301758368540085,
    -61.445611733827505, -61.42712196900927, -61.43698942053795,
    -61.44602383502673, -61.43698942053795, -61.622673433974754,
    -61.42712196900927, -61.42712196900927, -61.681688732214155,
    -61.681688732214155, -61.52669684551009, -61.44287335398941,
    -61.50038687407986, -61.43698942053795, -61.63227064169885,
    -61.488112950128475, -61.159680562110935, -61.42712196900927,
    -61.66477390328993, -61.42712196900927, -61.43698942053795,
    -61.42712196900927, -61.43698942053795, -61.660327979154374,
    -61.43698942053795, -61.681688732214155, -61.67216012223884,
    -62.26050266021612, -61.42712196900927, -61.43698942053795,
    -61.67216012223884, -61.43698942053795, -61.42499948511995,
    -61.52669684551009, -61.52313959799515, -61.43698942053795,
    -61.42712196900927, -61.35148722775864, -61.655415775109795,
    -61.67059313314969, -61.59601079178756, -61.63080263093031,
    -61.52669684551009, -61.42712196900927, -61.48113183320125,
    -61.43698942053795, -61.42712196900927, -61.34825866520155,
    -61.48948765311322, -61.488112950128475, -61.42712196900927,
    -61.43698942053795, -61.159680562110935, -61.45029766125027,
    -61.43698942053795, -61.43698942053795, -61.21170474051353,
    -61.1921811112531,
])
GTR_SUBSTITUTION_GRADIENTS = np.array([
    [37.37450626752085, -75.29788860620711, 69.43935430704154,
     -125.7528023286616, 74.61405128401657, -553.0478160564726,
     -97.9475700563386, 287.58209606673495],
    [37.37450626752085, -75.29788860620711, 69.43935430704154,
     -125.7528023286616, 74.61405128401657, -553.0478160564726,
     -97.9475700563386, 287.58209606673495],
    [36.19053504157635, -75.77642534559747, 69.3917718697112,
     -126.21328012676449, 74.25887093435685, -555.4452829645165,
     -98.71550003953224, 287.6570451307733],
    [37.37553809344446, -74.62381175902885, 68.98119333187559,
     -124.39863067267069, 74.77202193696141, -550.8187309622937,
     -99.48189646531735, 288.6725205826812],
    [37.50285436018544, -75.48631578635693, 69.39816740647056,
     -124.77092598172769, 74.70581835735612, -552.1752795202394,
     -96.3066940826561, 287.0355248543127],
    [36.19053504157635, -75.77642534559747, 69.3917718697112,
     -126.21328012676449, 74.25887093435685, -555.4452829645165,
     -98.71550003953224, 287.6570451307733],
    [35.73709796468088, -74.72118667228663, 69.81694511865842,
     -124.13110282415816, 73.48403387350074, -553.9754879368842,
     -99.76516080838827, 287.7282756985213],
    [36.288204904886285, -75.17717936023098, 69.43753103746555,
     -124.78090473404248, 73.87803795442832, -554.4604885663691,
     -99.83955206208118, 287.7635385101621],
    [36.288204904886285, -75.17717936023098, 69.43753103746555,
     -124.78090473404248, 73.87803795442832, -554.4604885663691,
     -99.83955206208118, 287.7635385101621],
    [37.47201893821999, -74.72357634865382, 69.4826702236545,
     -124.33979148182523, 74.23418838950244, -552.0436445465191,
     -99.08970426161964, 287.6930988009878],
])
GTR_SITE_GRADIENTS = np.array([
    -19055.840498591067, -19055.840498591067, -19067.658784565938,
    -19041.12216153288, -19055.251518859117, -19067.658784565938,
    -19062.94895152681, -19061.01239077452, -19061.01239077452,
    -19048.819934253996,
])

# Tolerances, (atol, rtol) as tools/tpu_parity.py sets them (BASELINE.md's
# float32 policy: LLs of magnitude ~5e3 atol 0.5, gradients rtol 2e-2).
TOL = {
    "ll": (0.5, 1e-5), "grad": (0.5, 2e-2), "rooted_ll": (0.5, 0.0),
    "ldj": (1e-3, 0.0), "shape": (0.05, 2e-2), "gp": (5e-3, 0.0),
    "vbpi": (5e-3, 0.0),
}
DTYPE = torch.float32  # the production configuration


class Check(NamedTuple):
    name: str
    err: float  # the largest absolute error
    bound: float  # atol + rtol * max |golden|
    ok: bool


def _check(name, got, want, tol):
    """A Check of got (values, or a list of calls' values) against want."""
    atol, rtol = tol
    want = np.asarray(want, np.float64)
    calls = got if isinstance(got, list) else [got]
    errs = []
    for g in calls:
        if isinstance(g, torch.Tensor):
            g = g.detach().cpu()
        g = np.asarray(g, np.float64)
        if g.shape != want.shape or not np.all(np.isfinite(g)):
            errs.append(np.inf)
        else:
            errs.append(float(np.max(np.abs(g - want))))
    err = max(errs)
    bound = atol + rtol * float(np.max(np.abs(want)))
    return Check(name, err, bound, bool(err <= bound))


def _twice(fn):
    """fn's outputs of two calls: on a card the engine's first call runs
    eagerly and its second is its graph's replay."""
    return [fn(), fn()]


def _unrooted(tree_file, spec, device):
    inst = UnrootedInstance("parity")
    if tree_file.endswith(".t"):
        inst.read_nexus_file(os.path.join(DATA, tree_file))
    else:
        inst.read_newick_file(os.path.join(DATA, tree_file))
    inst.read_fasta_file(os.path.join(DATA, "DS1.fasta"))
    inst.prepare_for_phylo_likelihood(spec, device=device, dtype=DTYPE)
    return inst


def _f64(x, device):
    return torch.tensor(x, dtype=torch.float64, device=device)


def ds1_checks(device):
    """DS1: K1's LLs and branch gradient, K2's Weibull+4 LLs."""
    inst = _unrooted("DS1.subsampled_10.t",
                     PhyloModelSpec("JC69", "constant", "strict"), device)
    sched, bl = inst._batched_schedule(), inst.branch_length_matrix()
    params = default_parameters(inst.engine.spec, device=device)
    calls = _twice(lambda: inst.engine.branch_gradients(sched, bl, params))
    last = [np.sort(np.concatenate([g[-1].cpu().numpy(), [0.0, 0.0]]))
            for _, g in calls]
    out = [_check("DS1 JC69 LLs vs pybeagle (K1)", [ll for ll, _ in calls],
                  PYBEAGLE_LIKELIHOODS, TOL["ll"]),
           _check("DS1 last-tree branch gradient vs physher (K1)", last,
                  PHYSHER_GRADIENTS, TOL["grad"])]
    inst = _unrooted("DS1.subsampled_10.t",
                     PhyloModelSpec("JC69", "weibull+4", "strict"), device)
    params = default_parameters(inst.engine.spec, device=device)
    params["site"]["shape"] = _f64(DS1_WEIBULL_SHAPE, device)
    got = _twice(lambda: inst.engine.log_likelihoods(sched, bl, params))
    out.append(_check("DS1 Weibull+4 LLs vs physher (K2)", got,
                      PHYSHER_WEIBULL_LIKELIHOODS, TOL["ll"]))
    return out


def _flua(spec, device):
    """(engine, arguments) of fluA's dated tree at CLOCK_RATE."""
    inst = RootedInstance("parity")
    inst.read_newick_file(os.path.join(DATA, "fluA.tree"))
    inst.read_fasta_file(os.path.join(DATA, "fluA.fa"))
    inst.parse_dates_from_taxon_names(True)
    inst.set_clock_rates(CLOCK_RATE)
    inst.prepare_for_phylo_likelihood(spec, device=device, dtype=DTYPE)
    return inst.engine, [inst._batched_schedule(), *inst._time_tree_arrays(),
                         inst.phylo_model_params]


def flua_checks(device):
    """fluA rooted: the strict clock (K2; the hand route, K1), GTR (the
    autograd route, K5 + K6), JC69 + Weibull+4 (K2 + K3)."""
    eng, args = _flua(PhyloModelSpec("JC69", "constant", "strict"), device)
    parts = _twice(lambda: eng.rooted_log_likelihoods(*args, True))
    grads = _twice(lambda: eng.rooted_phylo_gradients(*args))
    out = [_check("fluA strict-clock LL vs physher (K2)",
                  [ll[0] for ll, _ in parts], PHYSHER_LL, TOL["rooted_ll"]),
           _check("fluA log-det-Jacobian vs physher",
                  [ldj[0] for _, ldj in parts], PHYSHER_JACOBIAN, TOL["ldj"]),
           _check("fluA 68 ratio and root-height gradients vs physher (hand "
                  "route, K1)", [g["ratios_root_height"][0] for g in grads],
                  PHYSHER_RATIO_GRADIENTS, TOL["grad"])]
    eng, args = _flua(PhyloModelSpec("GTR", "constant", "strict"), device)
    args[-1]["substitution"] = {"rates": _f64(ROOTED_GTR_RATES, device),
                                "frequencies": _f64(ROOTED_GTR_FREQS, device)}
    parts = _twice(lambda: eng.rooted_log_likelihoods(*args, True))
    grads = _twice(lambda: eng.rooted_phylo_gradients(*args))
    out += [_check("fluA GTR LL vs phylotorch (K5)",
                   [ll[0] for ll, _ in parts], ROOTED_GTR_LL,
                   TOL["rooted_ll"]),
            _check("fluA GTR substitution gradient, stick space (autograd "
                   "route, K5 + K6)", [g["substitution_model"][0]
                                       for g in grads],
                   ROOTED_GTR_GRADIENTS, TOL["grad"])]
    eng, args = _flua(PhyloModelSpec("JC69", "weibull+4", "strict"), device)
    args[-1]["site"] = {"shape": _f64(ROOTED_WEIBULL_SHAPE, device)}
    parts = _twice(lambda: eng.rooted_log_likelihoods(*args, True))
    grads = _twice(lambda: eng.rooted_phylo_gradients(*args))
    out += [_check("fluA Weibull+4 LL vs physher (K2)",
                   [ll[0] for ll, _ in parts], ROOTED_WEIBULL_LL,
                   TOL["rooted_ll"]),
            _check("fluA Weibull+4 shape gradient (K2 + K3)",
                   [g["site_model"][0] for g in grads],
                   ROOTED_WEIBULL_SHAPE_GRADIENT, TOL["shape"])]
    return out


def _gp(fasta, newick_file, device, use_kernels="auto"):
    inst = GPInstance("parity")
    inst.read_fasta_file(os.path.join(DATA, fasta))
    inst.read_newick_file(os.path.join(DATA, newick_file))
    inst.make_engine(dtype=DTYPE, device=device, use_kernels=use_kernels)
    return inst


def gp_checks(device):
    """GP: hello's fixed-branch marginal (K7 on a card), five_taxon's
    converged ascent by the kernel route (K7 + K8) and the level route."""
    inst = _gp("hello.fasta", "hello_rooted.nwk", device)
    eng = inst.get_engine()
    eng.branch_lengths = np.array(GP_HELLO_BL)
    inst.populate_plvs()
    inst.compute_likelihoods()
    route = "K7" if eng.use_kernels else "level route"
    out = [_check(f"GP hello fixed-branch marginal ({route})",
                  eng.get_log_marginal_likelihood(), GP_HELLO, TOL["gp"])]
    for use_kernels, route in ((True, "kernel route, K7 + K8"),
                               (False, "level route")):
        eng = _gp("five_taxon.fasta", "five_taxon_rooted.nwk", device,
                  use_kernels).get_engine()
        marginal, sweeps = eng.run_branch_ascent(1e-4, 100)
        out.append(_check(f"GP five_taxon converged marginal, {route} "
                          f"({sweeps} sweeps)", marginal, GP_FIVE_TAXON,
                          TOL["gp"]))
    return out


def vbpi_instance(device, dtype=DTYPE):
    """hello as tools/tpu_parity.py trains it: the SBN by simple average."""
    inst = UnrootedInstance("parity-vbpi")
    inst.read_nexus_file(os.path.join(DATA, "hello_out.t"))
    inst.process_loaded_trees()
    inst.train_simple_average()
    inst.read_fasta_file(os.path.join(DATA, "hello.fasta"))
    inst.prepare_for_phylo_likelihood(
        PhyloModelSpec("JC69", "constant", "strict"), device=device,
        dtype=dtype)
    return inst


def vbpi_checks(device):
    """One VBPI step (K1; on a card the trainer's step graph)."""
    from ..vi.jit_step import JitVBPI

    jv = JitVBPI(vbpi_instance(device), particle_count=VBPI_PARTICLES,
                 seed=VBPI_SEED, dtype=DTYPE)
    m = jv.step(beta=VBPI_BETA)
    return [_check("VBPI step mean_ll vs the CPU float64 step (K1)",
                   m["mean_ll"], VBPI_MEAN_LL, TOL["vbpi"]),
            _check("VBPI step elbo_like vs the CPU float64 step (K1)",
                   m["elbo_like"], VBPI_ELBO_LIKE, TOL["vbpi"])]


def gtr_checks(device):
    """Config 2's model on DS1.100_topologies: phylo_gradients (K4, then
    K5 + K6) against libsbn_tpu's float64 values."""
    inst = _unrooted("DS1.100_topologies.nwk",
                     PhyloModelSpec("GTR", "weibull+4", "strict"), device)
    params = inst.phylo_model_params
    params["substitution"] = {"rates": _f64(GTR_RATES, device),
                              "frequencies": _f64(GTR_FREQS, device)}
    params["site"]["shape"] = _f64(GTR_SHAPE, device)
    sched, bl = inst._batched_schedule(), inst.branch_length_matrix()
    grads = _twice(lambda: inst.engine.phylo_gradients(sched, bl, params))
    return [
        _check("DS1.100 GTR + Weibull+4 LLs vs libsbn_tpu (K4)",
               [g["log_likelihood"] for g in grads], GTR_LIKELIHOODS,
               TOL["ll"]),
        _check("DS1.100 GTR + Weibull+4 edge-0 branch gradients vs "
               "libsbn_tpu (K4)", [g["branch_lengths"][:, 0] for g in grads],
               GTR_GRADIENTS_BL0, TOL["grad"]),
        _check("DS1.100 GTR substitution gradients, 10 trees (K5 + K6)",
               [g["substitution_model"][:10] for g in grads],
               GTR_SUBSTITUTION_GRADIENTS, TOL["grad"]),
        _check("DS1.100 GTR shape gradients, 10 trees (K5 + K6)",
               [g["site_model"][:10] for g in grads], GTR_SITE_GRADIENTS,
               TOL["grad"]),
    ]


SUBSYSTEMS = (ds1_checks, flua_checks, gp_checks, vbpi_checks, gtr_checks)


def format_check(c: Check) -> str:
    return (f"{'ok  ' if c.ok else 'FAIL'} {c.name}: max|err|={c.err:.3e} "
            f"(bound {c.bound:.1e})")


def run(device=DEFAULT_DEVICE, record=False, echo=print):
    """Every check on ``device`` (the card unless "cpu"), each line passed
    to ``echo`` as it is made; returns the list of Checks. Raises
    AssertionError naming the failures unless ``record``."""
    device = compute_device(device)
    checks = []
    for subsystem in SUBSYSTEMS:
        for c in subsystem(device):
            echo(format_check(c))
            checks.append(c)
    failed = [c.name for c in checks if not c.ok]
    if failed and not record:
        raise AssertionError(f"parity: {len(failed)} failures: {failed}")
    return checks


def main(argv=None):
    from ..vi.soak import card_name

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--record", action="store_true",
                        help="print the checks without asserting")
    parser.add_argument("--device", default=DEFAULT_DEVICE,
                        help="cpu, or a CUDA device (default: the card)")
    args = parser.parse_args(argv)
    device = compute_device(args.device)
    where = (f"{torch.cuda.get_device_name(device)}; {card_name()}"
             if device.type == "cuda" else "cpu (the kernels' twins)")
    print(f"parity tier on {where}, float32")
    try:
        checks = run(device, record=args.record)
    except AssertionError as err:
        print(f"PARITY: {err}")
        return 1
    failed = sum(not c.ok for c in checks)
    print(f"PARITY: {len(checks)} checks, {failed} failed"
          + (" (recorded, not asserted)" if args.record else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
