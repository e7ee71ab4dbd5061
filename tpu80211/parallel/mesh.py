"""Device mesh + sharding — the GSPMD replacement for the reference's MPI
runtime.

The reference hand-builds its distribution story out of MPI primitives
(SURVEY.md §2.3): frame-level process groups of 15 ranks (P5,
main_mpi.c:21-27,62-93), cyclic subcarrier splits with manual ceil/floor
load balancing (P3, main_mpi.c:172-174), 5-group×4-rank reduction trees
(P4, main_mpi.c:366-385), a 13-rank hand-scheduled dataflow graph (P6,
main_mpi.c:744-771), and Re/Im-plane Send/Recv marshalling (P8,
utils.c:780-795).  Here all of that is two named mesh axes:

  * ``dp``  — frames sharded across chips (the reference's frame groups);
  * ``blk`` — optional OFDM-block-axis sharding *within* a frame (the
    reference's intra-frame 15-rank split).  Estimator math is independent
    per block except the final average over the first ``avg_blocks``
    blocks, which becomes one ``lax.psum`` over ``blk`` — the only
    cross-device communication in the entire pipeline.

`MPI_Bcast` of constants → replicated trace-time constants; `MPI_Reduce` →
`psum`; worker→root `Send/Recv` gathers → outputs stay device-resident
(no gather at all); `MPI_Barrier` timing fences → dispatch ordering +
`block_until_ready`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpu80211 import constants as C
from tpu80211.cplx import Cplx
from tpu80211.pipeline import sc

DP, BLK = "dp", "blk"


def make_mesh(dp: int | None = None, blk: int = 1, devices=None) -> Mesh:
    """Build a ('dp', 'blk') mesh over ``devices`` (default: all).

    ``dp`` defaults to n_devices // blk.  With blk=1 this is the pure
    frame-data-parallel mesh (the reference's 20×1 frame-group sweep row —
    its own best configuration per main_mpi.c:1053-1055).
    """
    devices = np.asarray(devices if devices is not None else jax.devices())
    if dp is None:
        dp = devices.size // blk
    assert dp * blk == devices.size, (dp, blk, devices.size)
    return Mesh(devices.reshape(dp, blk), (DP, BLK))


def frame_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for (batch, …) frame arrays: batch over dp, rest replicated."""
    return NamedSharding(mesh, P(DP))


def shard_batch(mesh: Mesh, tree):
    """Device-put a pytree of (batch, …) arrays with batch sharded over dp."""
    return jax.device_put(tree, frame_sharding(mesh))


# -- data-parallel pipeline (GSPMD: sharding in, compiler inserts the rest) ----


def rx_chain_dp(mesh: Mesh, avg_blocks: int = C.N_AVG_BLOCKS):
    """jit the full RX chain with batch-sharded inputs/outputs.

    Frames are embarrassingly parallel, so GSPMD compiles this to zero
    collectives — each device runs its shard of the batch.  Returns the
    compiled callable (tx_pkt, rx_pkt, tx_lp, rx_lp as Cplx) → RxOutputs.
    """
    spec = frame_sharding(mesh)
    fn = functools.partial(sc.rx_chain, avg_blocks=avg_blocks)
    return jax.jit(
        fn,
        in_shardings=(spec, spec, spec, spec),
        out_shardings=spec,
    )


# -- explicitly-collective pipeline (shard_map over dp × blk) ------------------


def rx_step_shardmap(mesh: Mesh, avg_blocks: int = C.N_AVG_BLOCKS,
                     solver: str = "sm"):
    """Full RX step as a `shard_map` with explicit collectives.

    ``solver``: "sm" (rank-1 Sherman-Morrison closed form, the production
    default) or "dense" (the dense build + Cholesky solve — the
    reference's distributed computational shape, inverse_mpi at
    utils.c:273-353 / main_mpi.c:636-742, composed with the mesh: frames
    sharded over ``dp``, dense per-block 53×53 solves device-local, the
    4-block average as the ``blk`` psum).

    Layout: frames sharded over ``dp``; the 15-block axis of each frame
    block-sharded over ``blk`` (padded 15 → 16 = blk·⌈15/blk⌉ blocks, the
    pad weighted zero).  The pilot/MMSE per-block estimates are computed on
    local blocks only and combined with one weighted `lax.psum` over
    ``blk`` — the equivalent of the reference's intra-frame group
    reduction (main_mpi.c:467-481).  A second `psum` over ``dp``+``blk``
    produces the global mean-square CFR metric (the MPI_Reduce at the end
    of every reference run).

    Returns ``(step, nb_pad)``: ``step`` is the compiled callable
    (tx_pre, rx_pre, tx_blocks, rx_blocks, ow2) sharded →
    (RxOutputs with per-frame fields, global_mse scalar), and ``nb_pad``
    is the padded block count its block-axis inputs must have (pad with
    pad_blocks()).
    """
    blk_size = mesh.shape[BLK]
    nb_pad = -(-C.N_BLOCKS // blk_size) * blk_size  # ceil to multiple
    nb_local = nb_pad // blk_size

    def step(tx_pre, rx_pre, tx_blocks, rx_blocks, ow2):
        # local shapes: (b_loc, 53), (b_loc, nb_local, 53), (b_loc,)
        h_lt = sc.lt_ls(tx_pre, rx_pre)

        # which global block indices live on this blk shard
        bidx = jax.lax.axis_index(BLK)
        local_ids = bidx * nb_local + jnp.arange(nb_local)
        w_avg = (local_ids < avg_blocks).astype(jnp.float32)  # (nb_local,)

        def psum_avg(per_block: Cplx) -> Cplx:
            # mean over the first avg_blocks global blocks; mask with
            # `where` (not multiply) so NaNs from 0/0 pilot ratios on pad
            # blocks (whose tx is all-zero) are dropped, not propagated
            m = (w_avg > 0)[:, None]
            s = Cplx(
                jnp.sum(jnp.where(m, per_block.re, 0.0), axis=-2),
                jnp.sum(jnp.where(m, per_block.im, 0.0), axis=-2),
            )
            s = jax.lax.psum(s, BLK)
            return s * (1.0 / avg_blocks)

        hp = sc.pilot_ratios(tx_blocks, rx_blocks)  # (b_loc, nb_local, 4)

        def interp(kind):
            from tpu80211.cplx import matmul, matmul_real
            from tpu80211.ops.interp import interp_matrix

            w = interp_matrix(kind)
            if np.iscomplexobj(w):  # the Wiener map rotates phase
                h = matmul(hp, Cplx.from_complex(w))
            else:
                h = matmul_real(hp, jnp.asarray(w, jnp.float32))
            return psum_avg(h)

        h_lin = interp("linear")
        h_cub = interp("cubic")
        h_sin = interp("sinc")
        h_spl = interp("spline")
        h_wie = interp("wiener")

        # MMSE: per-local-block estimates, then the same psum-average
        h_mmse = psum_avg(
            _mmse_per_block(tx_blocks, rx_blocks, ow2, h_lt, solver)
        )

        # equalize local blocks with their *global* block index in the
        # LT↔PS blend (WiFi_Equalization.m:4); PS-Linear blend matches the
        # golden model and sc.rx_chain_freq's default (WiFi_RX.m:60)
        eq = sc.equalize(rx_blocks, h_lt, h_lin, block_ids=local_ids)

        # global scalar metric: mean |H_mmse|² over all frames.  h_mmse is
        # already invariant over blk (psum_avg reduced that axis), so only
        # a dp psum is needed — the counterpart of the reference's final
        # MPI_Reduce-to-rank-0.
        local_pow = jnp.sum(h_mmse.abs2())
        n_frames = jnp.asarray(tx_pre.shape[0], jnp.float32)
        glob = jax.lax.psum(jnp.stack([local_pow, n_frames * C.N_SC]), DP)
        mse = glob[0] / glob[1]

        return (
            sc.RxOutputs(h_lt, h_lin, h_cub, h_sin, h_spl, h_wie, h_mmse, eq, ow2),
            mse,
        )

    pspec = jax.sharding.PartitionSpec
    in_specs = (
        pspec(DP),            # tx_pre
        pspec(DP),            # rx_pre
        pspec(DP, BLK),       # tx_blocks (batch, blocks, 53)
        pspec(DP, BLK),       # rx_blocks
        pspec(DP),            # ow2
    )
    out_specs = (
        sc.RxOutputs(
            h_lt=pspec(DP),
            h_linear=pspec(DP),
            h_cubic=pspec(DP),
            h_sinc=pspec(DP),
            h_spline=pspec(DP),
            h_wiener=pspec(DP),
            h_mmse=pspec(DP),
            eq=pspec(DP, BLK),
            ow2=pspec(DP),
        ),
        pspec(),
    )
    mapped = jax.shard_map(step, mesh=mesh, in_specs=in_specs, out_specs=out_specs)
    return jax.jit(mapped), nb_pad


def _mmse_per_block(tx_blocks: Cplx, rx_blocks: Cplx, ow2, h_lt: Cplx,
                    solver: str = "sm") -> Cplx:
    """Per-block (un-averaged) MMSE estimates (…, nb, 53).

    v = F·ifft(H_LT) = H_LT exactly (see sc.ps_mmse_sm) — no transforms.
    solver="sm": the closed form s = uᴴrx/(σ²+‖u‖²) (MATH-mode collapse,
    see config.EstimatorMode / sc.ps_mmse_sm).  solver="dense": the dense
    Cholesky solve of the explicit Ryy z = rx system per block and
    s = uᴴz — the reference's distributed shape (utils.c:273-353)."""
    vb = h_lt.astype(jnp.float32)[..., None, :]
    u = tx_blocks.astype(jnp.float32) * vb
    if solver == "dense":
        from tpu80211.ops.linalg import rank1_solve

        ow2_b = jnp.broadcast_to(
            jnp.asarray(ow2, jnp.float32)[..., None], u.shape[:-1]
        )
        z = rank1_solve(u, rx_blocks.astype(jnp.float32), ow2_b)
        s = (u.conj() * z).sum(axis=-1)
    else:
        denom = jnp.asarray(ow2)[..., None] + u.abs2().sum(axis=-1)
        urx = (u.conj() * rx_blocks).sum(axis=-1)
        s = Cplx(urx.re / denom, urx.im / denom)
    return vb * Cplx(s.re[..., None], s.im[..., None])


def pad_blocks(x: np.ndarray, blk: int) -> np.ndarray:
    """Pad the block axis (axis 1 of (B, 15, 53)) up to a multiple of blk."""
    nb = x.shape[1]
    nb_pad = -(-nb // blk) * blk
    if nb_pad == nb:
        return x
    pad = [(0, 0)] * x.ndim
    pad[1] = (0, nb_pad - nb)
    return np.pad(x, pad)
