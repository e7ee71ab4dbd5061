"""Compiled-HLO collective assertions (VERDICT.md round-1 missing#4).

Without multi-chip hardware, the *checked* property available is the
compiled program structure: the dp (frame-parallel) path must contain no
inter-device collectives at all — frames are embarrassingly parallel, the
design bet endorsed by the reference's own frame-group sweep
(main_mpi.c:1053-1080, BASELINE.md) — and the dp×blk shard_map step must
contain exactly the two intended reductions:

  * one all-reduce over the ``blk`` subgroups (XLA's combiner merges the
    six per-estimator psum_avg calls — 2 planes × 6 estimators incl. the
    Wiener interpolator — into a single tuple all-reduce): the 4-block
    average, the counterpart of the reference's intra-frame group reduction
    (main_mpi.c:467-481);
  * one all-reduce over the ``dp`` groups: the global MSE metric, the
    counterpart of the reference's final MPI_Reduce-to-rank-0.

Anything else appearing (all-gather, collective-permute, all-to-all,
reduce-scatter, or extra all-reduces) is a sharding regression.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu80211 import constants as C
from tpu80211.cplx import Cplx
from tpu80211.datasets import synthetic
from tpu80211.parallel import make_mesh, pad_blocks, rx_chain_dp, rx_step_shardmap

OTHER_COLLECTIVES = (
    "all-gather", "collective-permute", "all-to-all", "reduce-scatter",
)


def _c(x):
    return Cplx.from_complex(np.asarray(x), jnp.float32)


def _all_reduce_groups(hlo: str) -> list[str]:
    """replica_groups of every all-reduce op in the compiled HLO."""
    groups = []
    for line in hlo.splitlines():
        # the result type may be a tuple with spaces, so match loosely
        if re.search(r"= .* all-reduce(-start)?\(", line):
            m = re.search(r"replica_groups=(\{\{[^A-Za-z]*?\}\})", line)
            assert m, line
            groups.append(m.group(1))
    return groups


@pytest.fixture(scope="module")
def batch():
    return synthetic.generate(jax.random.PRNGKey(7), batch=16, dtype=jnp.complex64)


def test_dp_path_has_zero_collectives(batch):
    mesh = make_mesh(dp=8, blk=1)
    pkt_tx = _c(synthetic.synthesize_time(batch.tx_symb))
    pkt_rx = _c(synthetic.synthesize_time(batch.rx_symb))
    lts = synthetic.synthesize_time(
        jnp.broadcast_to(batch.tx_preamble_fft[:, None, :], batch.tx_symb.shape)
    )[:, C.N_CP : C.N_CP + C.N_FFT]
    lp = _c(jnp.concatenate([lts[:, :32], lts, lts], axis=-1))
    hlo = rx_chain_dp(mesh).lower(pkt_tx, pkt_rx, lp, lp).compile().as_text()

    assert _all_reduce_groups(hlo) == []
    for name in OTHER_COLLECTIVES:
        assert f" {name}(" not in hlo and f" {name}-start(" not in hlo, name


def test_mesh_device_stream_step(batch):
    """Multi-device generative stream: per-dp-shard generation + chain
    under shard_map, correct statistics, deterministic,
    and at most the two intended dp all-reduces (packed summary + checksum)
    in the compiled program — the whole streamed system scales as
    chips × single-chip minus one scalar reduction per batch."""
    from tpu80211.pipeline import stream

    mesh = make_mesh(dp=4, blk=1, devices=jax.devices()[:4])
    step, s0 = stream.make_device_stream_step(512, snr_db=35.0, mesh=mesh)
    summary, sample_h, st = step(jnp.int32(0), s0)
    assert float(summary["h_lt_nmse"]) < 0.1
    assert sample_h.shape == (53, 512)  # 128-sample slices × 4 shards
    # deterministic per (i, state)
    s2, h2, _ = step(jnp.int32(0), s0)
    np.testing.assert_array_equal(np.asarray(sample_h.re), np.asarray(h2.re))
    # statistics agree with the single-device step (different shard seeds)
    step1, s1 = stream.make_device_stream_step(512, snr_db=35.0)
    sm1, _, _ = step1(jnp.int32(0), s1)
    assert abs(float(summary["h_lt_nmse"]) - float(sm1["h_lt_nmse"])) < 0.05
    # collective budget: ≤2 dp all-reduces, nothing else
    hlo = step.lower(jnp.int32(0), s0).compile().as_text()
    groups = _all_reduce_groups(hlo)
    assert 1 <= len(groups) <= 2, groups
    for name in OTHER_COLLECTIVES:
        assert f" {name}(" not in hlo and f" {name}-start(" not in hlo, name


def test_shardmap_path_has_exactly_the_intended_psums(batch):
    dp, blk = 4, 2
    mesh = make_mesh(dp=dp, blk=blk)
    step, nb_pad = rx_step_shardmap(mesh)
    txb = pad_blocks(np.asarray(batch.tx_symb), blk)[:, :nb_pad]
    rxb = pad_blocks(np.asarray(batch.rx_symb), blk)[:, :nb_pad]
    args = (
        _c(batch.tx_preamble_fft), _c(batch.rx_preamble_fft),
        _c(txb), _c(rxb), jnp.asarray(batch.ow2),
    )
    hlo = step.lower(*args).compile().as_text()

    groups = _all_reduce_groups(hlo)
    assert len(groups) == 2, groups
    # blk groups: consecutive device pairs; dp groups: stride-blk combs
    blk_groups = "{{0,1},{2,3},{4,5},{6,7}}"
    dp_groups = "{{0,2,4,6},{1,3,5,7}}"
    assert blk_groups in groups, groups
    assert dp_groups in groups, groups
    for name in OTHER_COLLECTIVES:
        assert f" {name}(" not in hlo and f" {name}-start(" not in hlo, name
