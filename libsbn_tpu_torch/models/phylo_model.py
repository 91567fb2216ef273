"""Phylogenetic model composition: substitution x site x clock.

The reference's src/phylo_model.{hpp,cpp}, as in libsbn_tpu.models.
phylo_model: a model is a string triple, e.g. {"JC69" | "GTR", "constant" |
"weibull+K", "none" | "strict"}. Parameters are a plain dict of tensors
(``{"substitution": {"rates", "frequencies"}, "site": {"shape"}, "clock":
{"rate"}}``), the same nesting as the JAX package's parameter pytree, and a
BlockSpecification maps them to the reference's flat vector.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from ..ops import site_model as site_ops
from ..ops import substitution as subst_ops
from .block_specification import BlockSpecification


@dataclass(frozen=True)
class PhyloModelSpec:
    substitution: str = "JC69"
    site: str = "constant"
    clock: str = "strict"

    def site_category_count(self) -> int:
        if self.site == "constant":
            return 1
        if self.site.startswith("weibull"):
            if "+" in self.site:
                return int(self.site.split("+")[1])
            return 4
        raise ValueError(f"Site model not known: {self.site}")


# Block keys matching the reference's strings.
GTR_RATES_KEY = "GTR rates"
FREQUENCIES_KEY = "frequencies"
WEIBULL_SHAPE_KEY = "Weibull shape"
CLOCK_RATE_KEY = "clock rate"
ENTIRE_SUBSTITUTION = "entire substitution"
ENTIRE_SITE = "entire site"
ENTIRE_CLOCK = "entire clock"


def check_spec(spec: PhyloModelSpec):
    """Raise ValueError on a substitution or site model not known here."""
    if spec.substitution not in ("JC69", "GTR"):
        raise ValueError(f"Substitution model not known: {spec.substitution}")
    spec.site_category_count()


def default_parameters(
    spec: PhyloModelSpec, *, dtype=torch.float64, device="cpu"
) -> Dict:
    """The default parameter dict for a model specification (GTR: uniform
    exchangeabilities 1/6 and frequencies 1/4)."""
    check_spec(spec)

    def tensor(x):
        return torch.tensor(x, dtype=dtype, device=device)

    params: Dict = {}
    if spec.substitution == "GTR":
        params["substitution"] = {
            "rates": tensor(subst_ops.DEFAULT_GTR_RATES),
            "frequencies": tensor(subst_ops.DEFAULT_FREQS),
        }
    if spec.site.startswith("weibull"):
        params["site"] = {"shape": tensor(1.0)}
    if spec.clock == "strict":
        params["clock"] = {"rate": tensor(1.0)}
    elif spec.clock != "none":
        raise ValueError(f"Clock model not known: {spec.clock}")
    return params


def params_from_numpy(params: Dict, device, dtype) -> Dict:
    """The JAX package's parameter dict, as numpy arrays or Python numbers,
    to this package's dict of tensors with the same nesting."""
    return {
        k: params_from_numpy(v, device, dtype)
        if isinstance(v, dict)
        else torch.as_tensor(np.array(v), dtype=dtype, device=device)
        for k, v in params.items()
    }


def block_specification(spec: PhyloModelSpec) -> BlockSpecification:
    """Flat-vector layout mirroring PhyloModel::PhyloModel composition
    (phylo_model.cpp): substitution blocks, then site, then clock, with
    "entire <submodel>" spans."""
    check_spec(spec)
    subst = BlockSpecification(
        [(GTR_RATES_KEY, 6), (FREQUENCIES_KEY, 4)]
        if spec.substitution == "GTR"
        else []
    )
    site = BlockSpecification(
        [(WEIBULL_SHAPE_KEY, 1)] if spec.site.startswith("weibull") else []
    )
    clock = BlockSpecification(
        [(CLOCK_RATE_KEY, 1)] if spec.clock == "strict" else []
    )
    out = BlockSpecification([])
    out.append(ENTIRE_SUBSTITUTION, subst)
    out.append(ENTIRE_SITE, site)
    out.append(ENTIRE_CLOCK, clock)
    return out


def parameters_from_flat(
    spec: PhyloModelSpec, v, *, dtype=torch.float64, device="cpu"
) -> Dict:
    """Flat parameter vector -> parameter dict (SetParameters analog)."""
    bs = block_specification(spec)
    bs.check_parameter_vector_size(v)
    v = np.asarray(v, dtype=np.float64)

    def segment(key):
        return torch.tensor(bs.extract_segment(v, key), dtype=dtype,
                            device=device)

    params: Dict = {}
    if spec.substitution == "GTR":
        params["substitution"] = {
            "rates": segment(GTR_RATES_KEY),
            "frequencies": segment(FREQUENCIES_KEY),
        }
    if spec.site.startswith("weibull"):
        params["site"] = {"shape": segment(WEIBULL_SHAPE_KEY)[0]}
    if spec.clock == "strict":
        params["clock"] = {"rate": segment(CLOCK_RATE_KEY)[0]}
    return params


def flat_from_parameters(spec: PhyloModelSpec, params: Dict) -> np.ndarray:
    """Parameter dict -> flat float64 vector (inverse of
    parameters_from_flat)."""
    bs = block_specification(spec)
    v = np.zeros(bs.parameter_count())

    def put(key, value):
        start, size = bs.get_map()[key]
        v[start : start + size] = np.asarray(
            torch.as_tensor(value).detach().cpu(), dtype=np.float64
        ).reshape(size)

    if spec.substitution == "GTR":
        put(GTR_RATES_KEY, params["substitution"]["rates"])
        put(FREQUENCIES_KEY, params["substitution"]["frequencies"])
    if spec.site.startswith("weibull"):
        put(WEIBULL_SHAPE_KEY, params["site"]["shape"])
    if spec.clock == "strict":
        put(CLOCK_RATE_KEY, params["clock"]["rate"])
    return v


def substitution_tensors(
    spec: PhyloModelSpec, params: Dict, *, dtype=torch.float64, device="cpu"
):
    """(freqs (4,), Q (4, 4)) of the substitution model. GTR's Q is built
    straight from the parameters, never from an eigensystem, so autograd
    never passes through eigh (the transition matrices differentiate
    through ``expm_transition``)."""
    check_spec(spec)
    if spec.substitution == "JC69":
        freqs = torch.full((4,), 0.25, dtype=dtype, device=device)
        return freqs, subst_ops.jc69_q(dtype=dtype, device=device)
    p = params["substitution"]
    rates = torch.as_tensor(p["rates"], dtype=dtype, device=device)
    freqs = torch.as_tensor(p["frequencies"], dtype=dtype, device=device)
    return freqs, subst_ops.gtr_q(rates, freqs)


def site_tensors(
    spec: PhyloModelSpec, params: Dict, *, dtype=torch.float64, device="cpu"
):
    """(rates (K,), props (K,)) of the site model."""
    if spec.site == "constant":
        return site_ops.constant_rates(dtype=dtype, device=device)
    if spec.site.startswith("weibull"):
        return site_ops.weibull_rates(
            params["site"]["shape"], spec.site_category_count(),
            dtype=dtype, device=device,
        )
    raise ValueError(f"Site model not known: {spec.site}")


def model_tensors(
    spec: PhyloModelSpec, params: Dict, *, dtype=torch.float64, device="cpu"
):
    """Lower a parameter dict to (freqs, evec, ivec, evals, rates, props, Q),
    all in ``dtype`` (float64 by default, as the JAX package computes them
    before its engine casts)."""
    freqs, Q = substitution_tensors(spec, params, dtype=dtype, device=device)
    if spec.substitution == "JC69":
        _, evec, ivec, evals = subst_ops.jc69_eigen(dtype=dtype, device=device)
    else:
        evals, evec, ivec = subst_ops._eigen_of_q(Q, freqs)
    rates, props = site_tensors(spec, params, dtype=dtype, device=device)
    return freqs, evec, ivec, evals, rates, props, Q
