#!/usr/bin/env python
"""Accuracy record of the generative raw system across SNR.

This sweep runs the generative raw system (pipeline/raw.gen_raw_system
— channel + AWGN + random timing offset + ±20 kHz CFO per stream) at
each SNR and records, per point:

  * detection rate (the `threshold = 4e-3` stage the reference promises,
    WiFi_RX.m:7, characterized instead of hard-coded);
  * timing: fraction inside the [-4,-2] advance band and inside the
    cyclic-prefix margin [-8, 0];
  * median |CFO estimate − truth| in Hz (Moose);
  * post-CPE EVM with the production equalizer (equalize_with="h_mmse")
    over DETECTED streams.

Usage: python scripts/bench_raw_quality.py [batch]
Writes artifacts/raw_system_quality.json.
"""

from __future__ import annotations

import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax

from tpu80211.utils.compile_cache import enable_compile_cache

enable_compile_cache()

import jax.numpy as jnp
import numpy as np

from tpu80211.cplx import Cplx
from tpu80211.datasets.loader import load_capture
from tpu80211.ops.detect import detect_packet, lts_time_symbol
from tpu80211.pipeline.lane import tx_spectra
from tpu80211.pipeline.raw import gen_raw_system

SNRS = (-5.0, 0.0, 5.0, 10.0, 15.0, 20.0, 30.0, 40.0)


def main():
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    cap = load_capture()
    txs, tpre = tx_spectra(Cplx.from_complex(cap.tx_packet, jnp.float32),
                           Cplx.from_complex(cap.tx_lptot, jnp.float32))
    lts = lts_time_symbol(Cplx.from_complex(cap.tx_lptot))
    lts = Cplx(jnp.asarray(lts.re, jnp.float32),
               jnp.asarray(lts.im, jnp.float32))
    den = float(np.sum(np.asarray(txs.re[:, :15]) ** 2
                       + np.asarray(txs.im[:, :15]) ** 2)) / 15.0

    rows = []
    for si, snr in enumerate(SNRS):
        out = gen_raw_system(jnp.int32(100 + si), batch, txs, tpre, lts,
                             snr_db=float(snr), equalize_with="h_mmse",
                             cfo_khz=20.0)
        det = np.asarray(out["detected"])
        err = np.asarray(out["start"]) - np.asarray(out["offsets"])
        cfo_err_hz = np.abs(np.asarray(out["cfo"])
                            - np.asarray(out["cfo_true"])) * 20e6
        evm_s = np.asarray(out["evm_sums"])
        d = det
        row = {
            "snr_db": float(snr),
            "batch": batch,
            "detect_rate": round(float(det.mean()), 4),
            "timing_in_band_rate": round(
                float(((err >= -4) & (err <= -2) & d).sum()
                      / max(d.sum(), 1)), 4),
            "timing_within_cp_rate": round(
                float(((err >= -8) & (err <= 0) & d).sum()
                      / max(d.sum(), 1)), 4),
            "cfo_median_err_hz": round(float(np.median(cfo_err_hz[d])), 1)
            if d.any() else None,
            "evm_rms_detected": round(
                float(np.sqrt(evm_s[d].mean() / (15.0 * den))), 4)
            if d.any() else None,
        }
        rows.append(row)
        print(json.dumps(row))

    # ---- false-alarm rate on pure noise vs threshold (the ROC's other
    # axis; complements the sensitivity rows above) ----------------------
    rng = np.random.default_rng(0)
    nb = 8192
    noise = (rng.standard_normal((nb, 2048))
             + 1j * rng.standard_normal((nb, 2048))) * 0.01
    xn = Cplx(jnp.asarray(noise.real, jnp.float32),
              jnp.asarray(noise.imag, jnp.float32))
    fa_rows = []
    for thr in (0.3, 0.4, 0.5, 0.6):
        res = detect_packet(xn, lts, threshold=thr, stride=16)
        fa = float(np.asarray(res["detected"]).mean())
        fa_rows.append({"threshold": thr, "false_alarm_rate": fa,
                       "streams": nb})
        print(json.dumps(fa_rows[-1]))

    out_doc = {
        "metric": "generative raw system accuracy vs SNR (detection, "
                  "timing, CFO recovery, post-CPE EVM; cfo_khz=20, "
                  "equalize_with=h_mmse)",
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
        "device_count": len(jax.devices()),
        "rows": rows,
        "false_alarm_on_noise": fa_rows,
    }
    path = pathlib.Path(__file__).resolve().parents[1] / "artifacts"
    path.mkdir(exist_ok=True)
    (path / "raw_system_quality.json").write_text(
        json.dumps(out_doc, indent=1))
    print(json.dumps({"wrote": str(path / "raw_system_quality.json")}))


if __name__ == "__main__":
    main()
