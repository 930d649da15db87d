"""`field_tail_gates.tail_rounded_as` on the CPU: the plain field tail
that takes another implementation's bf16 roundings of its hidden layers,
read back through probe weights.  chip_smoke.py holds K7 by it on the
trained steps; here the other implementation is the plain tail itself, the
same math in float64 sums (which rounds some hidden values to the other
bf16 neighbour), or the plain math with one fault.

    python -m pytest -q tests/test_torch_tail_rounded.py
"""
import pytest
import torch

from ngp_pl_torch.benchmarking import field_tail_gates as ftg
from ngp_pl_torch.ops import field_tail as ft

torch.set_num_threads(2)

TOL = 1e-5            # chip_smoke.K7_ROUNDED_TOL


@pytest.fixture(scope="module")
def args():
    h1, sh = ftg.tail_inputs(4096, *ftg.K7_INPUTS)
    return (h1, sh, *ftg.model_weights())


def test_plain_reads_its_own_roundings(args):
    """Read back from the plain tail, every rounding is its own: the
    returned outputs are the plain tail's bit for bit."""
    (sigma, rgb), seen = ftg.tail_rounded_as(ft.field_tail_plain, *args, TOL)
    ref = ft.field_tail_plain(*args)
    assert torch.equal(sigma, ref[0]) and torch.equal(rgb, ref[1])
    assert seen["flips"] == 0 and seen["out_of_window"] == 0
    assert seen["max_rel_err"] == 0.0
    assert 0 < seen["unread"] < 4096 * 144


def test_float64_sums_rounded_as(args):
    """The tail in float64 sums rounds a few hidden values to the other
    bf16 neighbour, which moves its rgb by ~2e-4 from the f32 plain tail;
    with those roundings taken the plain tail lies within 1e-5 of it (f32
    against float64 sums of the last layer and of h[0]), and every value
    it rounds otherwise lies in the window."""
    f64 = lambda *a: ft.field_tail_plain(*a, acc=torch.float64)  # noqa: E731
    assert ftg.k7_error(f64(*args), ft.field_tail_plain(*args)) > 1e-4
    _, seen = ftg.tail_rounded_as(f64, *args, TOL)
    assert seen["flips"] > 0 and seen["out_of_window"] == 0
    assert seen["max_rel_err"] <= TOL


def _biased(*a):
    sigma, rgb = ft.field_tail_plain(*a)
    return sigma, rgb + 10 * TOL


@pytest.mark.parametrize("wrong", ftg.K7_WRONG + ("rgb_plus_10_tol",))
def test_wrong_tails_are_refused(args, wrong):
    """Each of field_tail_gates' wrong tails, and the plain tail with 10 x
    the limit added to rgb, rounds values outside the window or misses
    the returned outputs past the limit."""
    tail = _biased if wrong == "rgb_plus_10_tol" else (
        lambda *a: ftg.variant(wrong, *a))
    _, seen = ftg.tail_rounded_as(tail, *args, TOL)
    assert seen["out_of_window"] > 0 or seen["max_rel_err"] > TOL
