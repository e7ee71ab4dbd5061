"""chip_smoke.py's phases at tiny sizes on the CPU: the same code paths,
comparisons and gates the card runs at benchmark sizes."""

import pathlib
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402


def test_main_exits_nonzero_without_gpu(capsys):
    assert chip_smoke.main([]) != 0
    assert '"ok": true' not in capsys.readouterr().out


def test_phase_chain_f32_tiny():
    chip_smoke.phase_chain_f32(batch=64, n_ref=16)


def test_phase_txconst_tiny():
    chip_smoke.phase_txconst(batch=256)


def test_phase_raw_tiny():
    chip_smoke.phase_raw(batch=16, ns=2048, strides=(16, 32))


def test_phase_gen_raw_tiny():
    chip_smoke.phase_gen_raw(batch=64)


def test_phase_stream_tiny():
    chip_smoke.phase_stream(batch=128, n_batches=2)


def test_phase_dense_tiny():
    chip_smoke.phase_dense(batch=64)


def test_four_cards_tiny():
    """The --four-cards path on four virtual CPU devices."""
    chip_smoke.four_cards(batch_per_card=128, n_dev=4)


def test_check_fails_loudly():
    """A comparison outside its tolerance raises (no phase failure is
    swallowed)."""
    with pytest.raises(AssertionError):
        chip_smoke._check("x", 2.0, 1.0)
