"""ctypes bindings to the native C++ data engine (native/dataengine.cpp).

The host-side producer for pipeline/stream.py: generates batches of
synthetic frames directly into f32 split-complex planes (the device
storage format) with std::thread parallelism — the native-runtime
counterpart of `datasets/synthetic.py` (which generates on the JAX CPU
backend).  The reference's "data loader" is a compiled-in header
(inputs.h) replayed across MPI frame groups (main_mpi.c:62-93); here the
loader is a real streaming component, so it is native like the rest of
the reference's runtime.

Deterministic in (seed, frame0 + i) independent of thread count — the
resume property the stream driver's cursor relies on.  Distribution
families match synthetic.generate but the RNG differs, so frames are
statistically equivalent, not bitwise equal, across engines.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib
import subprocess
from typing import NamedTuple

import numpy as np

from tpu80211 import constants as C
from tpu80211.cplx import Cplx
from tpu80211.datasets.synthetic import FrameBatch, _lts_spectrum

_NATIVE_DIR = pathlib.Path(__file__).resolve().parents[2] / "native"
_SO = _NATIVE_DIR / "build" / "libdataengine.so"

_F = ctypes.POINTER(ctypes.c_float)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    if not _SO.exists():
        subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                       capture_output=True)
    lib = ctypes.CDLL(str(_SO))
    lib.gen_frames_f32.argtypes = (
        [ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int64,
         ctypes.c_double, ctypes.c_double, ctypes.c_int]
        + [_F] * 20
    )
    lib.gen_frames_f32.restype = None
    return lib


class TimeBatch(NamedTuple):
    """Time-domain view of a generated batch (split-complex planes)."""

    tx_pkt: Cplx   # (B, 1200)
    rx_pkt: Cplx   # (B, 1200)
    tx_lp: Cplx    # (B, 160)
    rx_lp: Cplx    # (B, 160)


def _f32(shape):
    return np.empty(shape, np.float32)


def _ptr(a):
    return a.ctypes.data_as(_F)


def generate(
    batch: int,
    seed: int = 0,
    frame0: int = 0,
    snr_db: float = 40.0,
    fo_hz: float = 0.0,
    sample_rate_hz: float = 20e6,
    threads: int = 0,
    time_domain: bool = False,
):
    """Generate ``batch`` frames starting at global index ``frame0``.

    Returns a FrameBatch of numpy complex64 arrays (mirroring
    synthetic.generate), or ``(FrameBatch, TimeBatch)`` with
    ``time_domain=True`` — the TimeBatch planes feed the time-domain
    chain without any further host-side math.
    """
    b = int(batch)
    lts = np.ascontiguousarray(_lts_spectrum().astype(np.float32))
    tpre = (_f32((b, C.N_SC)), _f32((b, C.N_SC)))
    rpre = (_f32((b, C.N_SC)), _f32((b, C.N_SC)))
    tx = (_f32((b, C.N_BLOCKS, C.N_SC)), _f32((b, C.N_BLOCKS, C.N_SC)))
    rx = (_f32((b, C.N_BLOCKS, C.N_SC)), _f32((b, C.N_BLOCKS, C.N_SC)))
    ow2 = _f32((b,))
    h = (_f32((b, C.N_SC)), _f32((b, C.N_SC)))

    if time_domain:
        tpkt = (_f32((b, C.PACKET_SAMPLES)), _f32((b, C.PACKET_SAMPLES)))
        rpkt = (_f32((b, C.PACKET_SAMPLES)), _f32((b, C.PACKET_SAMPLES)))
        tlp = (_f32((b, C.PREAMBLE_SAMPLES)), _f32((b, C.PREAMBLE_SAMPLES)))
        rlp = (_f32((b, C.PREAMBLE_SAMPLES)), _f32((b, C.PREAMBLE_SAMPLES)))
        tptrs = [_ptr(x) for pair in (tpkt, rpkt, tlp, rlp) for x in pair]
    else:
        tptrs = [ctypes.cast(None, _F)] * 8

    cfo_rad = 2.0 * np.pi * fo_hz * C.SAMP_PER_BLOCK / sample_rate_hz
    _lib().gen_frames_f32(
        int(seed), int(frame0), b, float(snr_db), float(cfo_rad),
        int(threads), _ptr(lts),
        _ptr(tpre[0]), _ptr(tpre[1]), _ptr(rpre[0]), _ptr(rpre[1]),
        _ptr(tx[0]), _ptr(tx[1]), _ptr(rx[0]), _ptr(rx[1]),
        _ptr(ow2), _ptr(h[0]), _ptr(h[1]),
        *tptrs,
    )

    def cx(pair):
        return (pair[0] + 1j * pair[1]).astype(np.complex64)

    fb = FrameBatch(cx(tpre), cx(rpre), cx(tx), cx(rx), ow2, cx(h))
    if not time_domain:
        return fb
    tb = TimeBatch(
        Cplx(*tpkt), Cplx(*rpkt), Cplx(*tlp), Cplx(*rlp)
    )
    return fb, tb


def available() -> bool:
    """True if the native library builds/loads on this machine."""
    try:
        _lib()
        return True
    except (subprocess.CalledProcessError, OSError):
        return False
