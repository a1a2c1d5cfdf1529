"""Cases that run only with `-m slow`: tier-1 runs `-m 'not slow'`."""
import pytest

# Cases too slow for tier-1's clock, run with `-m slow`. Each compiles every
# variant of one of lws_tpu's TPU-only throughput knobs in Pallas interpret
# mode; lws_tpu is the frozen reference. Seconds: `-m slow -n 4`, 8 CPU cores.
_SLOW = (
    "tests/test_pallas.py::test_frame_unroll_is_bit_neutral",  # 422 s, frame_unroll
    "tests/test_pallas.py::test_rows_carry_is_bit_neutral[jacobi]",  # 261 s, window_carry="rows"
    "tests/test_pallas.py::test_rows_carry_is_bit_neutral[color2x3]",  # 234 s, window_carry="rows"
    "tests/test_pallas.py::test_lane_fold_is_bit_neutral",  # 155 s, lane_fold
)


@pytest.hookimpl(tryfirst=True)  # before the mark plugin deselects by -m
def pytest_collection_modifyitems(items):
    for item in items:
        if item.nodeid in _SLOW:
            item.add_marker(pytest.mark.slow)
