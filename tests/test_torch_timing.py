"""`timing.per_call_us`: device time per call from a profile's records,
whole or with records dropped, as the profiler on the card drops them late
in a long process."""
import pytest

from ngp_pl_torch.benchmarking.timing import FLUSH_KERNEL, per_call_us

FLUSH = f"void at::native::{FLUSH_KERNEL}_kernel_cuda"


def test_a_whole_window_reads_the_sum_over_the_calls():
    us, calls = per_call_us([(FLUSH, 20, 4000.0), ("bwd", 20, 3000.0),
                             ("fill", 20, 300.0)], 20, True)
    assert calls == 20
    assert us == {"bwd": pytest.approx(150.0), "fill": pytest.approx(15.0)}


@pytest.mark.parametrize("flushes, kept", [(18, 19), (12, 12), (14, 15)])
def test_dropped_records_leave_the_time_per_call_unchanged(flushes, kept):
    """A window that kept `kept` of 20 records of each kernel, and
    `flushes` of the flushes (counts read on the H100), reads the time per
    call of the whole window."""
    us, calls = per_call_us([(FLUSH, flushes, 200.0 * flushes),
                             ("fwd", kept, 97.5 * kept),
                             ("pair", 2 * kept, 10.0 * 2 * kept)], 20, True)
    assert calls == flushes
    assert us == {"fwd": pytest.approx(97.5), "pair": pytest.approx(20.0)}


def test_a_kernel_in_fewer_than_half_the_calls_is_left_out():
    us, _ = per_call_us([(FLUSH, 20, 4000.0), ("k", 20, 2000.0),
                         ("once", 1, 50.0)], 20, True)
    assert us == {"k": pytest.approx(100.0)}


def test_without_a_flush_the_calls_are_the_runs():
    us, calls = per_call_us([("k", 17, 1700.0), ("fill", 20, 40.0)], 20,
                            False)
    assert calls == 20
    assert us == {"k": pytest.approx(100.0), "fill": pytest.approx(2.0)}


def test_a_window_without_flushes_keeps_no_kernel():
    us, calls = per_call_us([("k", 20, 2000.0)], 20, True)
    assert (us, calls) == ({}, 0)
