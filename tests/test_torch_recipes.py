"""The port's benchmark recipes (ngp_pl_torch/benchmarking/recipes/) against
the JAX repository's (benchmarking/benchmark_*.sh): the same scenes, flags
and ROOT_DIR defaults, each calling `python -m ngp_pl_torch.train`; valid
bash; and the synthetic recipe's SMOKE=1 run trains on the CPU."""
import os
import re
import subprocess
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX_DIR = REPO / "benchmarking"
PORT_DIR = REPO / "ngp_pl_torch" / "benchmarking" / "recipes"
NAMES = sorted(p.name for p in JAX_DIR.glob("benchmark_*.sh"))


def _statements(path: Path, port: bool):
    """The script's statements, continuations joined, comments and blank
    lines left out, and the train invocation written one way: the port's
    PYTHONPATH preamble and the smoke run's --device flag are dropped."""
    text = path.read_text().replace("\\\n", " ")
    out = []
    for line in text.splitlines():
        line = " ".join(line.split())
        if not line or line.startswith("#"):
            continue
        if port and (line.startswith("REPO=")
                     or line.startswith("export PYTHONPATH=")):
            continue
        line = line.replace("python -m ngp_pl_torch.train", "python TRAIN")
        line = line.replace('python "$(dirname "$0")/../train.py"',
                            "python TRAIN")
        line = re.sub(r"^python train\.py", "python TRAIN", line)
        line = line.replace(' --device "${DEVICE:-cuda}"', "")
        out.append(line)
    return out


def test_seven_recipes():
    assert len(NAMES) == 7
    assert sorted(p.name for p in PORT_DIR.glob("benchmark_*.sh")) == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_same_scenes_and_flags(name):
    jax = _statements(JAX_DIR / name, port=False)
    port = _statements(PORT_DIR / name, port=True)
    assert port == jax
    code = [ln for ln in (PORT_DIR / name).read_text().splitlines()
            if ln.strip() and not ln.strip().startswith("#")]
    calls = [ln for ln in code if re.search(r"\bpython\b", ln)]
    assert calls and all("python -m ngp_pl_torch.train" in ln
                         for ln in calls)


@pytest.mark.parametrize("name", NAMES)
def test_bash_syntax(name):
    r = subprocess.run(["bash", "-n", str(PORT_DIR / name)],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr


def test_smoke_run_trains_on_the_cpu(tmp_path):
    """SMOKE=1 DEVICE=cpu: the JAX recipe's hermetic 48-step run of the
    flagship on the procedural scene, through the port's train entry
    point, from a directory outside the repository."""
    env = dict(os.environ, SMOKE="1", DEVICE="cpu", OMP_NUM_THREADS="2")
    env.pop("PYTHONPATH", None)
    r = subprocess.run(
        ["bash", str(PORT_DIR / "benchmark_synthetic_nerf.sh")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert re.search(r"^test: psnr=", r.stdout, re.M)
    assert (tmp_path / "ckpts" / "synthetic" / "smoke_recipe"
            / "epoch=1_slim.npz").exists()
