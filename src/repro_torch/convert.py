"""Build the port's GP, fused-ask, fleet and LM state from numpy arrays.

Lets both packages compute on one fitted GP, take one ask or fleet step
from one state, or run one LM's weights: the caller turns the other
package's state into numpy arrays (``np.asarray``) and hands them here.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.engine.ask import AskConfig, AskEngine
from repro_torch.engine.engine import EvalEngine
from repro_torch.engine.fleet import FleetEngine, _Block, _Study
from repro_torch.gp.gpr import GPState
from repro_torch.gp.kernels import KernelParams
from repro_torch.models.lm import per_layer


def _tensor(a, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.float64, copy=True)).to(dev)


def gp_state_from_numpy(*, x_train, y_train, log_lengthscale, log_amplitude,
                        log_noise, chol, alpha, kinv=None,
                        kernel: str = "matern52",
                        device=None) -> GPState:
    """float64 GPState on ``device`` from numpy arrays.  ``None`` means
    the card, as at every entry point (``repro_torch.resolve_device``):
    it raises without one, so pass ``device="cpu"`` on the CPU."""
    dev = resolve_device(device)

    def t(a) -> torch.Tensor:
        return _tensor(a, dev)

    kinv_t: Optional[torch.Tensor] = None if kinv is None else t(kinv)
    params = KernelParams(log_lengthscale=t(log_lengthscale),
                          log_amplitude=t(log_amplitude),
                          log_noise=t(log_noise))
    return GPState(x_train=t(x_train), y_train=t(y_train), params=params,
                   chol=t(chol), alpha=t(alpha), kernel=kernel, kinv=kinv_t)


def ask_engine_from_numpy(engine: EvalEngine, cfg: AskConfig, *, x, y, n: int,
                          n_fit: int, theta, chol, alpha, kinv=None,
                          since_refit: int = 0) -> AskEngine:
    """An :class:`AskEngine` on ``engine.device`` holding a fitted state.

    ``x`` (b, D) and ``y`` (b,) are the padded observation buffers with
    ``n`` live rows; ``theta`` (P,), ``chol``, ``alpha`` and ``kinv``
    (fused backend) describe the fit over the first ``n_fit`` of them.
    With ``n == n_fit + 1`` the next ``suggest()`` is incremental (while
    ``since_refit < cfg.refit_interval - 1``).
    """
    dev = engine.device
    ask = AskEngine(engine, cfg)
    ask._x, ask._y = _tensor(x, dev), _tensor(y, dev)
    ask._n, ask._n_fit, ask._since_refit = int(n), int(n_fit), since_refit
    ask._theta, ask._chol = _tensor(theta, dev), _tensor(chol, dev)
    ask._alpha = _tensor(alpha, dev)
    ask._kinv = None if kinv is None else _tensor(kinv, dev)
    return ask


def fleet_block_from_numpy(fleet: FleetEngine, *, x, y, theta, chol,
                           alpha, kinv=None, studies) -> _Block:
    """A slot block of ``fleet`` holding another fleet's block state.

    ``x`` (S, b, D) and ``y`` (S, b) are the stacked padded observation
    buffers, ``theta`` (S, P), ``chol``, ``alpha`` and ``kinv`` (fused
    backend) the stacked fits; S must be the fleet's block width
    (``cfg.slots`` a mesh device), and each leaf is split onto the mesh.
    ``studies`` has one entry a slot: ``None`` for an idle slot, else a
    dict with the study's ``sid`` and ``n`` (live rows), and optionally
    ``n_fit``, ``since_refit``, ``has_factor``, ``has_theta`` and
    ``trial`` (its bookkeeping, 0/False by default).  The studies are
    registered and installed without admission, so the next ``step()``
    takes the same path (incremental or full) as the source fleet's."""
    cpu = torch.device("cpu")
    x = np.asarray(x, np.float64)
    S = fleet._slots_total
    if x.shape[0] != S or len(studies) != S:
        raise ValueError(f"a block has {S} slots, got "
                         f"{x.shape[0]} rows and {len(studies)} studies")
    blk = _Block(fleet.cfg, x.shape[1], fleet._mesh)
    blk.x, blk.y, blk.theta, blk.chol, blk.alpha = (
        fleet._shard(_tensor(a, cpu)) for a in (x, y, theta, chol, alpha))
    if blk.kinv is not None:
        blk.kinv = fleet._shard(_tensor(kinv, cpu))
    y = np.asarray(y, np.float64)
    for s, rec in enumerate(studies):
        if rec is None:
            continue
        st = _Study(rec["sid"])
        n = int(rec["n"])
        st.xs = [x[s, i].copy() for i in range(n)]
        st.ys = [float(y[s, i]) for i in range(n)]
        st.tags = [None] * n
        st.n_fit = int(rec.get("n_fit", 0))
        st.since_refit = int(rec.get("since_refit", 0))
        st.has_factor = bool(rec.get("has_factor", False))
        st.has_theta = bool(rec.get("has_theta", False))
        st.trial = int(rec.get("trial", 0))
        st.block, st.slot = blk, s
        blk.studies[s] = st
        fleet._studies[st.sid] = st
    fleet._blocks.append(blk)
    return blk


def _lm_tensor(a, dev: torch.device) -> torch.Tensor:
    """A tensor of ``a``'s values and dtype; a bfloat16 array (numpy
    through ml_dtypes) is carried over bit for bit."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(dev)


def lm_params_from_numpy(tree, device=None, *, stacked: bool = False,
                         mesh=None, cfg=None):
    """The port's LM parameters from the JAX package's unboxed parameter
    tree as numpy arrays: ``{"embed", "final_norm", "blocks"}`` (dense,
    moe, vlm), ``{"embed", "final_norm", "triples", "tail"}`` (hybrid),
    ``{"embed", "final_norm", "groups"}`` (ssm) or ``{"embed", "enc",
    "dec", "enc_norm", "final_norm"}`` (whisper), each layer stack stacked
    over layers, and ``groups``' ``mlstm`` leaves stacked over groups then
    layers.  Every stack becomes one nested dictionary per layer (per
    group, holding a list of its mLSTM layers) of views, or, with
    ``stacked``, stays the one tensor (the reference's tree: what
    training holds).  Every dtype is kept (the router, ``lambda_param``,
    ``w_if`` and ``r_*`` stay float32 in a bfloat16 model).  On
    ``device``: ``None`` means the card, as at every entry point
    (``repro_torch.resolve_device``), and raises without one.

    With ``mesh`` (and the model's ``cfg``, whose ``lm.param_axes`` place
    the leaves: the dense and hybrid trees, a head dim split where kv_heads
    do not divide "model", the recurrent blocks' "lru" dims) each leaf is
    this rank's slice, on the mesh's device."""
    if mesh is not None:
        from repro_torch.distributed.sharding import shard_tree
        from repro_torch.models.lm import param_axes
        if cfg is None:
            raise ValueError("lm_params_from_numpy(mesh=) needs the model's "
                             "cfg")
        out = shard_tree(_tree_from_numpy(tree, torch.device("cpu")),
                         param_axes(cfg, mesh=mesh), mesh)
        return out if stacked else per_layer(out)
    out = _tree_from_numpy(tree, resolve_device(device))
    return out if stacked else per_layer(out)


def _tree_from_numpy(node, dev: torch.device):
    if isinstance(node, dict):
        return {k: _tree_from_numpy(v, dev) for k, v in node.items()}
    return _lm_tensor(node, dev)


def opt_state_from_numpy(state, device=None, *, mesh=None, cfg=None):
    """The port's ``AdamState`` from the JAX package's (``step``, ``mu``,
    ``nu``, ``ef`` with their trees unboxed, as numpy arrays): the moments
    and residuals as tensors on ``device`` (``None`` means the card), the
    step on the host, as the port keeps it.  With ``mesh`` (and the
    model's ``cfg``) each moment is this rank's ZeRO slice
    (``train/optim.py``), on the mesh's device."""
    from repro_torch.train.optim import AdamState, zero_sharding
    step, mu, nu, ef = state
    if mesh is not None:
        from repro_torch.distributed.sharding import zip_map
        from repro_torch.models.lm import param_axes
        if cfg is None:
            raise ValueError("opt_state_from_numpy(mesh=) needs the model's "
                             "cfg")
        axes = param_axes(cfg, mesh=mesh)

        def tree(t):
            return zip_map(lambda x, ax: zero_sharding(
                x.shape, ax, mesh).shard(x),
                _tree_from_numpy(t, torch.device("cpu")), axes)
    else:
        dev = resolve_device(device)

        def tree(t):
            return _tree_from_numpy(t, dev)
    return AdamState(
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32),
        mu=tree(mu), nu=tree(nu), ef=tree(ef) if isinstance(ef, dict) else ())
