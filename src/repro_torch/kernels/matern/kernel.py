"""CUDA kernels of the Matérn-5/2 GP: build, binding, wrappers.

``csrc/posterior.cu`` holds the fused posterior (see its header for what
the kernels replace, what bounds them and why they look as they do):

* :func:`matern52_posterior_fwd` (K1): mean, variance and the residual
  ``t = k* K⁻¹`` of a (q, D) query batch, in two launches: the split or
  the walk kernel, then the merge.  :func:`plan` picks the regime and the
  scratch from (q, n, D); the summation order depends on n alone, so a
  row has the same bits in either regime and at any q;
* :func:`matern52_posterior_bwd_xq` (K2): the gradient in the queries, in
  two launches: the split kernel (partials of each 64-column tile of
  training points to scratch), then the merge.  :func:`bwd_plan` picks the
  query rows a block and the scratch from (q, n, D); the sums follow an
  order fixed by n alone, so a row has the same bits at any q.

``csrc/gram.cu`` holds the gram matrix of the GP fit:

* :func:`matern52_gram_fwd` (K3): the (R, n1, n2) cross-gram for R θ rows;
* :func:`matern52_gram_bwd_theta` (K4): its gradient in (1/ℓ, σ_f²), in
  two launches: the tiles' partials to a wrapper-allocated scratch, then
  their merge.

:func:`gram_plan` gives both their tiles, blocks, D pieces and K4's
scratch from the shapes and :func:`same_points`: where x1 and x2 are the
same points (every call of the fit) only the tiles of the upper triangle
run.  K4's sums follow an order fixed by (n1, n2) and that choice, so a
θ row has the same bits at any R.  ``csrc/matern.cuh`` holds the Matérn
entry both sources round alike.

The sources are built with the port's other kernels into one library
at first use (``kernels/_build.py``); nothing is built at import.

Each wrapper takes the plain version (``ref.py``) for tensors on the CPU,
and only for those.  For CUDA tensors it checks device, dtype (float64),
shape and contiguity, allocates its outputs, launches on the current
stream, raises if the launch fails, and adds one to its launch count.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.kernels._build import (MAX_SMEM, check_launch,
                                        check_tensor, declare, on_cpu)
from repro_torch.kernels._build import lib as _lib
from repro_torch.kernels.matern.ref import (matern52_gram_bwd_theta_ref,
                                            matern52_gram_ref,
                                            matern52_posterior_bwd_ref,
                                            matern52_posterior_fwd_ref)

Tensor = torch.Tensor

# launches of each kernel; read and reset by callers that must show the
# main path went through the kernels (chip_smoke.py, EvalEngine stats)
LAUNCHES: Dict[str, int] = {"matern52_posterior_fwd": 0,
                            "matern52_posterior_bwd_xq": 0,
                            "matern52_gram_fwd": 0,
                            "matern52_gram_bwd_theta": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
declare("matern52_posterior_fwd", [_P] * 10 + [_I] * 5 + [_P], _I)
declare("matern52_posterior_bwd_xq", [_P] * 11 + [_I] * 5 + [_P], _I)
declare("matern52_gram_fwd", [_P] * 5 + [_I] * 7 + [_P], _I)
declare("matern52_gram_bwd_theta", [_P] * 8 + [_I] * 7 + [_P], _I)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


# K1's and K2's geometry, as posterior.cu has it (kChunk, kTile,
# kSplitRows, kWalkRows, kWalkCols, kStageRows, kPiece)
CHUNK = 64                       # rows of K⁻¹ a chunk: t sums chunk by chunk
TILE = 64                        # columns of a split block and a mean/var tile
SPLIT_ROWS = 16                  # query rows of a split block
WALK_ROWS = 32                   # query rows of a walk block
WALK_COLS = 256                  # columns of a walk block
STAGE_ROWS = 32                  # K⁻¹ rows of a walk ring stage
PIECE = 64                       # coordinates a split block stages at once
BWD_ROWS = 16                    # query rows of a K2 block past q = 16
N_SM = 132                       # the H100's SMs
MAX_SCRATCH = 32 << 20           # bytes of split scratch a call may take
_REGIMES = {"split": 0, "walk": 1}


class PosteriorPlan(NamedTuple):
    """How K1 runs a (q, n, D) call.  ``chunks`` = ceil(n / CHUNK) chunks
    of CHUNK rows of K⁻¹ partition [0, n): the summation order, the same
    in both regimes.  ``blocks`` is the first kernel's grid size, and
    ``scratch`` the doubles it writes for the merge (split: the chunks'
    partials and k*, (chunks + 1)·q·n; walk: 0)."""
    regime: str
    chunks: int
    blocks: int
    scratch: int

    def studies(self, s: int) -> "PosteriorPlan":
        """The plan of a call on S stacked studies: the same regime and
        order, S times the blocks and the scratch."""
        return self._replace(blocks=s * self.blocks, scratch=s * self.scratch)


def _split_smem(d: int) -> int:
    """The split kernel's shared memory: it stages D in pieces of at most
    PIECE coordinates, so this is the size of one piece's block."""
    pw = min(d, PIECE)
    return 8 * (CHUNK * TILE + CHUNK * SPLIT_ROWS + pw + SPLIT_ROWS * (pw | 1)
                + CHUNK * pw)


def _walk_smem(d: int) -> int:
    ds = d | 1
    return 8 * (2 * STAGE_ROWS * WALK_COLS + 3 * STAGE_ROWS * d
                + 2 * STAGE_ROWS * WALK_ROWS + d + WALK_ROWS * ds + WALK_ROWS)


@functools.lru_cache(maxsize=1024)
def plan(q: int, n: int, d: int) -> PosteriorPlan:
    """K1's regime for q queries, n training points, D dimensions.
    ``"split"`` (one block per TILE columns × chunk × SPLIT_ROWS queries,
    partials to scratch) while the walk's blocks would not fill the SMs
    and the partials stay within MAX_SCRATCH bytes: the MSO's rounds, q ≤
    16 at n ≤ 2048.  Otherwise ``"walk"`` (one block per WALK_ROWS
    queries × WALK_COLS columns walks every chunk, no scratch), whose
    shared memory holds D up to 81; past that the split regime runs
    whatever its scratch, at any D (it stages D in pieces).  Which blocks
    compute never changes the order of the sums, so a row is bitwise the
    same whichever regime its batch takes."""
    if q < 1 or n < 1 or d < 1:
        raise ValueError(f"empty posterior input (q={q}, n={n}, D={d})")
    chunks = -(-n // CHUNK)
    tiles, ds = -(-n // TILE), d | 1
    walk_blocks = -(-q // WALK_ROWS) * -(-n // WALK_COLS)
    scratch = (chunks + 1) * q * n
    walk_fits = max(_walk_smem(d), 8 * (d + 8 * (ds + 1) + 16 * tiles
                                        + TILE * ds)) <= MAX_SMEM
    if not walk_fits or (walk_blocks < N_SM and 8 * scratch <= MAX_SCRATCH):
        blocks = tiles * chunks * -(-q // SPLIT_ROWS)
        return PosteriorPlan("split", chunks, blocks, scratch)
    return PosteriorPlan("walk", chunks, walk_blocks, 0)


class BwdPlan(NamedTuple):
    """How K2 runs a (q, n, D) call.  ``tiles`` = ceil(n / TILE) column
    tiles of TILE training points partition [0, n): the summation order.
    ``rows`` is the split kernel's query rows a block, ``blocks`` its grid
    size, and ``scratch`` the doubles of its partials, tiles·q·(D + 1)."""
    rows: int
    tiles: int
    blocks: int
    scratch: int

    def studies(self, s: int) -> "BwdPlan":
        """The plan of a call on S stacked studies: the same rows and
        order, S times the blocks and the scratch."""
        return self._replace(blocks=s * self.blocks, scratch=s * self.scratch)


@functools.lru_cache(maxsize=1024)
def bwd_plan(q: int, n: int, d: int) -> BwdPlan:
    """K2's geometry for q queries, n training points, D dimensions: one
    split block per (column tile, ``rows`` queries), a row a block at q ≤
    16 (the MSO's rounds: 90 blocks at q = 10, n = 544), BWD_ROWS at
    larger q, so that a tile's training rows are staged once for that
    many queries.  The rows never change the order of the sums."""
    if q < 1 or n < 1 or d < 1:
        raise ValueError(f"empty posterior input (q={q}, n={n}, D={d})")
    tiles = -(-n // TILE)
    rows = 1 if q <= 16 else BWD_ROWS
    return BwdPlan(rows, tiles, tiles * -(-q // rows), tiles * q * (d + 1))


def _studies(xq: Tensor) -> Tuple[int, Tuple[int, ...]]:
    """(S, lead) of a posterior call: ``xq`` (q, D) is one study (lead
    ()), (S, q, D) a stack of S (lead (S,))."""
    if xq.ndim == 2:
        return 1, ()
    if xq.ndim == 3:
        return xq.shape[0], (xq.shape[0],)
    raise ValueError(f"xq must be (q, D) or (S, q, D), got {tuple(xq.shape)}")


def matern52_posterior_fwd(xq: Tensor, xt: Tensor, alpha: Tensor,
                           kinv: Tensor, inv_lengthscale: Tensor,
                           amplitude: Tensor
                           ) -> Tuple[Tensor, Tensor, Tensor]:
    """K1: ((q,) mean, (q,) var, (q, n) t = k* K⁻¹).

    With a leading study axis (xq (S, q, D), xt (S, n, D), alpha (S, n),
    kinv (S, n, n), inv_lengthscale (S, D), amplitude (S,)) one launch
    serves the S studies and returns (S, q), (S, q), (S, q, n); each
    study's slice is bitwise its solo call."""
    if on_cpu(xq):
        return matern52_posterior_fwd_ref(xq, xt, alpha, kinv,
                                          inv_lengthscale, amplitude)
    S, lead = _studies(xq)
    q, d = xq.shape[-2:]
    n = xt.shape[-2]
    dev = xq.device
    for name, x, shape in (("xq", xq, (q, d)), ("xt", xt, (n, d)),
                           ("alpha", alpha, (n,)), ("kinv", kinv, (n, n)),
                           ("inv_lengthscale", inv_lengthscale, (d,)),
                           ("amplitude", amplitude, ())):
        check_tensor(name, x, lead + shape, torch.float64, dev)
    p = plan(q, n, d).studies(S)
    mean = torch.empty(lead + (q,), dtype=torch.float64, device=dev)
    var = torch.empty(lead + (q,), dtype=torch.float64, device=dev)
    t = torch.empty(lead + (q, n), dtype=torch.float64, device=dev)
    scratch = (torch.empty((p.scratch,), dtype=torch.float64, device=dev)
               if p.scratch else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _lib().matern52_posterior_fwd(
            xq.data_ptr(), xt.data_ptr(), alpha.data_ptr(), kinv.data_ptr(),
            inv_lengthscale.data_ptr(), amplitude.data_ptr(),
            mean.data_ptr(), var.data_ptr(), t.data_ptr(),
            None if scratch is None else scratch.data_ptr(), q, n, d, S,
            _REGIMES[p.regime], stream)
    check_launch("matern52_posterior_fwd", err)
    LAUNCHES["matern52_posterior_fwd"] += 1
    return mean, var, t


def matern52_posterior_bwd_xq(xq: Tensor, xt: Tensor, alpha: Tensor,
                              t: Tensor, var: Tensor,
                              inv_lengthscale: Tensor, amplitude: Tensor,
                              g_mean: Tensor, g_var: Tensor) -> Tensor:
    """K2: ∂(ḡm·mean + ḡv·var)/∂xq, (q, D); with K1's leading study axis
    (S, q, D) in one launch, each study's slice bitwise its solo call."""
    if on_cpu(xq):
        return matern52_posterior_bwd_ref(xq, xt, alpha, t, var,
                                          inv_lengthscale, amplitude,
                                          g_mean, g_var)
    S, lead = _studies(xq)
    q, d = xq.shape[-2:]
    n = xt.shape[-2]
    dev = xq.device
    for name, x, shape in (("xq", xq, (q, d)), ("xt", xt, (n, d)),
                           ("alpha", alpha, (n,)), ("t", t, (q, n)),
                           ("var", var, (q,)),
                           ("inv_lengthscale", inv_lengthscale, (d,)),
                           ("amplitude", amplitude, ()),
                           ("g_mean", g_mean, (q,)), ("g_var", g_var, (q,))):
        check_tensor(name, x, lead + shape, torch.float64, dev)
    p = bwd_plan(q, n, d).studies(S)
    dxq = torch.empty(lead + (q, d), dtype=torch.float64, device=dev)
    scratch = torch.empty((p.scratch,), dtype=torch.float64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _lib().matern52_posterior_bwd_xq(
            xq.data_ptr(), xt.data_ptr(), alpha.data_ptr(), t.data_ptr(),
            var.data_ptr(), inv_lengthscale.data_ptr(), amplitude.data_ptr(),
            g_mean.data_ptr(), g_var.data_ptr(), dxq.data_ptr(),
            scratch.data_ptr(), q, n, d, S, p.rows, stream)
    check_launch("matern52_posterior_bwd_xq", err)
    LAUNCHES["matern52_posterior_bwd_xq"] += 1
    return dxq


# K3's and K4's geometry, as gram.cu has it (kT)
GRAM_TILE = 32                   # edge of the tile a block computes


class GramPlan(NamedTuple):
    """How K3 and K4 run an (R, n1, n2, D) call.  ``tiles``: the GRAM_TILE
    × GRAM_TILE tiles of a θ row that blocks compute, row-major over the
    (n1, n2) grid or, when ``symmetric`` (x1 and x2 the same points), over
    its upper triangle I ≤ J; they are K4's summation units, fixed by
    (n1, n2, symmetric).  ``blocks`` = R·tiles; ``pieces``: the pieces of
    PIECE coordinates a block stages in turn; ``scratch``: the doubles of
    K4's partials, R·(D + 1)·tiles."""
    symmetric: bool
    tiles: int
    blocks: int
    pieces: int
    scratch: int


@functools.lru_cache(maxsize=1024)
def gram_plan(r: int, n1: int, n2: int, d: int, symmetric: bool) -> GramPlan:
    """K3's and K4's geometry for R θ rows of an (n1, n2) gram in D
    dimensions.  At the MAP fit's shape (R = 2, n = 544, symmetric) 153
    tiles a θ row, 306 blocks over the 132 SMs.  Any D: a block stages D
    in pieces.  Refuses only empty inputs (and a symmetric plan of two
    sizes)."""
    if min(r, n1, n2, d) < 1:
        raise ValueError(f"empty gram input (R={r}, n1={n1}, n2={n2}, D={d})")
    if symmetric and n1 != n2:
        raise ValueError(f"a symmetric gram is square, not ({n1}, {n2})")
    t1, t2 = -(-n1 // GRAM_TILE), -(-n2 // GRAM_TILE)
    tiles = t1 * (t1 + 1) // 2 if symmetric else t1 * t2
    return GramPlan(bool(symmetric), tiles, r * tiles, -(-d // PIECE),
                    r * (d + 1) * tiles)


def gram_tile(t: int, n1: int, n2: int, symmetric: bool) -> Tuple[int, int]:
    """The tile (I, J) that block ``t`` of a θ row computes (gram.cu's
    ``tile_coords``): row-major over every tile, or over I ≤ J."""
    t2 = -(-n2 // GRAM_TILE)
    if not symmetric:
        return divmod(t, t2)
    i, row = 0, t2
    while t >= row:
        t, i, row = t - row, i + 1, row - 1
    return i, i + t


def same_points(x1: Tensor, x2: Tensor) -> bool:
    """True when x1 and x2 are the same points: one storage, with the same
    offset, shape, strides, dtype and device (the same tensor, a view of
    it, or what autograd saved of it); a copy is not."""
    return (x1 is x2 or (
        x1.device == x2.device and x1.dtype == x2.dtype
        and x1.shape == x2.shape and x1.stride() == x2.stride()
        and x1.storage_offset() == x2.storage_offset()
        and x1.untyped_storage().data_ptr()
        == x2.untyped_storage().data_ptr()))


class GramDims(NamedTuple):
    """A gram call's shape: S studies (lead () for one, (S,) for a
    stack), R θ rows a study, n1 × n2 points, D dimensions."""
    lead: Tuple[int, ...]
    s: int
    r: int
    n1: int
    n2: int
    d: int


def _gram_dims(x1: Tensor, x2: Tensor, inv_lengthscale: Tensor,
               amplitude: Tensor) -> GramDims:
    """x1 (n1, D), x2 (n2, D) with θ rows (R, D)/(R,); or a study axis:
    x1 (S, n1, D), x2 (S, n2, D) with (S, R, D)/(S, R)."""
    nd = x1.ndim
    if nd not in (2, 3) or x2.ndim != nd or inv_lengthscale.ndim != nd:
        raise ValueError("gram kernels take x1 (n1, D), x2 (n2, D), "
                         "inv_lengthscale (R, D), amplitude (R,), or the "
                         "same with a leading study axis S")
    lead = tuple(x1.shape[:-2])
    r, d = inv_lengthscale.shape[-2:]
    n1, n2 = x1.shape[-2], x2.shape[-2]
    dev = x1.device
    for name, x, shape in (("x1", x1, (n1, d)), ("x2", x2, (n2, d)),
                           ("inv_lengthscale", inv_lengthscale, (r, d)),
                           ("amplitude", amplitude, (r,))):
        check_tensor(name, x, lead + shape, torch.float64, dev)
    return GramDims(lead, lead[0] if lead else 1, r, n1, n2, d)


def matern52_gram_fwd(x1: Tensor, x2: Tensor, inv_lengthscale: Tensor,
                      amplitude: Tensor) -> Tensor:
    """K3: k(x1, x2) for each of R θ rows, (R, n1, n2); with a study axis
    (x (S, n, D), θ rows (S, R, D)/(S, R)) one launch for the S·R rows,
    (S, R, n1, n2), each study's rows bitwise its solo call."""
    if on_cpu(x1):
        return matern52_gram_ref(x1, x2, inv_lengthscale, amplitude)
    g = _gram_dims(x1, x2, inv_lengthscale, amplitude)
    rows = g.s * g.r
    p = gram_plan(rows, g.n1, g.n2, g.d, same_points(x1, x2))
    dev = x1.device
    out = torch.empty(g.lead + (g.r, g.n1, g.n2), dtype=torch.float64,
                      device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _lib().matern52_gram_fwd(
            x1.data_ptr(), x2.data_ptr(), inv_lengthscale.data_ptr(),
            amplitude.data_ptr(), out.data_ptr(), rows, g.n1, g.n2, g.d,
            p.tiles, int(p.symmetric), g.s, stream)
    check_launch("matern52_gram_fwd", err)
    LAUNCHES["matern52_gram_fwd"] += 1
    return out


def matern52_gram_bwd_theta(x1: Tensor, x2: Tensor, inv_lengthscale: Tensor,
                            amplitude: Tensor, g: Tensor
                            ) -> Tuple[Tensor, Tensor]:
    """K4: (∂/∂(1/ℓ) (R, D), ∂/∂σ_f² (R,)) of Σ g ⊙ K3(x1, x2, 1/ℓ, σ_f²);
    with K3's study axis ((S, R, D), (S, R)) in one launch."""
    if on_cpu(x1):
        return matern52_gram_bwd_theta_ref(x1, x2, inv_lengthscale,
                                           amplitude, g)
    gd = _gram_dims(x1, x2, inv_lengthscale, amplitude)
    check_tensor("g", g, gd.lead + (gd.r, gd.n1, gd.n2), torch.float64,
                 x1.device)
    rows = gd.s * gd.r
    p = gram_plan(rows, gd.n1, gd.n2, gd.d, same_points(x1, x2))
    dev = x1.device
    part = torch.empty((p.scratch,), dtype=torch.float64, device=dev)
    d_inv = torch.empty(gd.lead + (gd.r, gd.d), dtype=torch.float64,
                        device=dev)
    d_amp = torch.empty(gd.lead + (gd.r,), dtype=torch.float64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _lib().matern52_gram_bwd_theta(
            x1.data_ptr(), x2.data_ptr(), inv_lengthscale.data_ptr(),
            amplitude.data_ptr(), g.data_ptr(), part.data_ptr(),
            d_inv.data_ptr(), d_amp.data_ptr(), rows, gd.n1, gd.n2, gd.d,
            p.tiles, int(p.symmetric), gd.s, stream)
    check_launch("matern52_gram_bwd_theta", err)
    LAUNCHES["matern52_gram_bwd_theta"] += 1
    return d_inv, d_amp
