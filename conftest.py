"""Root test harness: one build directory per test process.

`ngp_pl_tpu.native` compiles its host library through a `.tmp` path in the
build directory, so pytest-xdist workers that share one directory race on
that path, and a worker that loses the race sees no library. Each process
gets its own directory under the gitignored `.native_build/`, set before any
test module is imported; `native._build_dir` reads the variable at call
time.
"""
import os
import shutil

_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    ".native_build", f"p{os.getpid()}")
os.environ["NGP_PL_TPU_BUILD_DIR"] = _DIR


def pytest_unconfigure(config):
    shutil.rmtree(_DIR, ignore_errors=True)
