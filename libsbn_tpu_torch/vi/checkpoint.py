"""Checkpoint/resume for VBPI training (the counterpart of
libsbn_tpu.vi.checkpoint).

Full training state round-trips through a single .npz in libsbn_tpu's
layout, so a checkpoint written by either package restores into the
other:
  * a Burrito: ``q_params``, ``sbn_parameters``, ``step_size``,
    ``sbn_step_size``, ``step_number``, ``elbo_trace``, the optimizer
    state as ``opt_leaf_<i>`` in optax's leaf order
    (vi/optimizers.py GroupedAscent.state_leaves), and ``meta_json``
    (particle count, VIMCO, the support's GPCSP count, checked on restore);
  * a JitVBPI's device state: ``leaf_<i>`` in the JAX VBPIState's leaf
    order, q_params, sbn_params, then (count, mu, nu) of the q_params
    group's Adam and of the sbn_params group's.
The SBN-parameter CSV path stays on the instance
(sbn_parameters_to_csv / read_sbn_parameters_from_csv).
"""

from __future__ import annotations

import json

import numpy as np

from .jit_step import AdamState, VBPIState


def save_burrito(burro, path: str):
    """Checkpoint a vi.Burrito to an .npz file."""
    opt = burro.opt
    payload = {
        "q_params": burro.scalar_model.q_params,
        "sbn_parameters": np.asarray(burro.inst.sbn_parameters),
        "step_size": np.asarray(opt.step_size),
        "sbn_step_size": np.asarray(opt.sbn_step_size),
        "step_number": np.asarray(opt.step_number),
        "elbo_trace": np.asarray(burro.elbo_trace, dtype=np.float64),
    }
    for i, leaf in enumerate(opt.ascent.state_leaves()):
        payload[f"opt_leaf_{i}"] = leaf
    meta = {
        "particle_count": burro.particle_count,
        "use_vimco": burro.use_vimco,
        "gpcsp_count": int(np.asarray(burro.inst.sbn_parameters).size),
    }
    payload["meta_json"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8
    )
    np.savez(path, **payload)


def restore_burrito(burro, path: str):
    """Restore training state saved by save_burrito (of either package)
    into a freshly constructed Burrito over the same data and support."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["meta_json"].tobytes()).decode())
        if meta["gpcsp_count"] != np.asarray(burro.inst.sbn_parameters).size:
            raise ValueError(
                "Checkpoint support size does not match this instance: "
                f"{meta['gpcsp_count']} vs "
                f"{np.asarray(burro.inst.sbn_parameters).size}. Was the "
                "checkpoint created with the same tree file and burn-in?"
            )
        burro.scalar_model.q_params[:] = data["q_params"]
        burro.inst.sbn_parameters = data["sbn_parameters"].copy()
        burro.inst._sampler = None
        opt = burro.opt
        opt.step_size = data["step_size"]
        opt.sbn_step_size = float(data["sbn_step_size"])
        opt.step_number = int(data["step_number"])
        n_leaves = len(opt.ascent.state_leaves())
        opt.ascent.load_state_leaves(
            [data[f"opt_leaf_{i}"].copy() for i in range(n_leaves)]
        )
        burro.elbo_trace = list(data["elbo_trace"])
    return burro


def _jit_leaves(state: VBPIState):
    leaves = [state.q_params, state.sbn_params]
    for adam in state.opt_state:
        leaves += [np.asarray(adam.count, np.int32), adam.mu, adam.nu]
    return leaves


def save_jit_state(jv, path: str):
    """Checkpoint a vi.jit_step.JitVBPI's state."""
    payload = {
        f"leaf_{i}": (x.detach().cpu().numpy() if hasattr(x, "detach")
                      else np.asarray(x))
        for i, x in enumerate(_jit_leaves(jv.state))
    }
    np.savez(path, **payload)


def restore_jit_state(jv, path: str):
    """Restore a state saved by save_jit_state (of either package) onto
    ``jv``'s device and dtype."""
    with np.load(path) as data:
        leaves = [data[f"leaf_{i}"] for i in range(8)]

    def t(a):
        return jv._tensor(a)

    jv.state = VBPIState(
        t(leaves[0]), t(leaves[1]),
        tuple(AdamState(t(leaves[i + 1]), t(leaves[i + 2]), int(leaves[i]))
              for i in (2, 5)),
    )
    return jv
