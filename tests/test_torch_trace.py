"""The training trace (`NeRFSystem.fit(profile_dir=...)`, `python -m
ngp_pl_torch.train --profile_dir`), as the JAX package's `fit` traces
(ngp_pl_tpu/training/system.py:476-505): steps 64-96, in 16-step blocks
or single steps, written as a Chrome trace; the fit's results do not
change.

Sizes: grid 32, L=4, log2 T=12, 64 rays a step, 24x24 views."""
import json
import re

import pytest
import torch

from ngp_pl_torch import train as ttrain
from ngp_pl_torch.training.system import TRACE_FILE, NeRFSystem
from tests.test_torch_entry_points import TOY, _small_system

torch.set_num_threads(2)


def _ranges(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted({e["name"] for e in events
                   if re.fullmatch(r"steps \d+-\d+", e.get("name", ""))},
                  key=lambda n: int(n.split()[1].split("-")[0]))


@pytest.mark.parametrize("steps, log_every, want", [
    (112, 16, ["steps 64-80", "steps 80-96"]),
    (100, 50, [f"steps {i}-{i + 1}" for i in range(64, 96)])])
def test_fit_traces_steps_64_to_96(tmp_path, steps, log_every, want):
    """Blocks when the counts allow, single steps otherwise: the trace holds
    exactly the calls from step 64 to 96, and the losses equal an untraced
    fit's."""
    traced = _small_system(batch_size=64)
    hist = traced.fit(max_steps=steps, log_every=log_every, quiet=True,
                      profile_dir=str(tmp_path))
    assert _ranges(tmp_path / TRACE_FILE) == want
    plain = _small_system(batch_size=64)
    ref = plain.fit(max_steps=steps, log_every=log_every, quiet=True)
    assert [h["loss"] for h in hist] == [h["loss"] for h in ref]


def test_short_fit_writes_no_trace(tmp_path):
    _small_system(batch_size=64).fit(max_steps=48, log_every=16, quiet=True,
                                     profile_dir=str(tmp_path))
    assert not (tmp_path / TRACE_FILE).exists()


def test_train_cli_profile_dir(tmp_path, monkeypatch):
    """The flag reaches the fit (whose trace the tests above hold)."""
    monkeypatch.chdir(tmp_path)
    seen = []
    monkeypatch.setattr(NeRFSystem, "fit", lambda self, max_steps,
                        profile_dir=None: seen.append(profile_dir))
    ttrain.main(TOY + ["--no_save_test", "--profile_dir", "prof"])
    assert seen == ["prof"]
