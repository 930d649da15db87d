"""The port's TensorBoard record (ngp_pl_torch/utils/events.py) against
tensorboardX's writer and tensorboard's reader, and against the JAX
package's fit: the record framing and masked CRC32C bytes equal
tensorboardX's, tensorboard's `EventAccumulator` reads a port fit's file
with the values of `history`, a JAX `NeRFSystem` fit and the port's log
the same tags at the same steps into the same relative directory, and
under two gloo ranks only rank 0 writes."""
import dataclasses
import os
import struct

import numpy as np
import pytest
import torch
from tensorboard.backend.event_processing.event_accumulator import (
    EventAccumulator,
)
from tensorboardX.proto.event_pb2 import Event
from tensorboardX.proto.summary_pb2 import Summary
from tensorboardX.record_writer import masked_crc32c as tbx_masked_crc32c

from ngp_pl_tpu.config import TrainConfig as JaxTrainConfig
from ngp_pl_tpu.datasets.synthetic import SyntheticDataset as JaxSynthetic
from ngp_pl_tpu.training.system import NeRFSystem as JaxSystem
from ngp_pl_torch import parallel
from ngp_pl_torch.utils import events
from tests import torch_ddp_workers as W

torch.set_num_threads(2)

TAGS = ["train/loss", "train/psnr", "train/rm_s", "train/vr_s"]


def test_masked_crc32c_matches_tensorboardx():
    rng = np.random.default_rng(0)
    for n in range(0, 301):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert events.masked_crc32c(data) == tbx_masked_crc32c(data), n
    assert events.crc32c(b"123456789") == 0xE3069283     # the check value


@pytest.mark.parametrize("step,value", [(0, 0.0), (1, -1.5), (300, 3e-7),
                                        (2 ** 40, float("nan"))])
def test_record_bytes_equal_tensorboardx(step, value):
    """The port's record of an Event equals tensorboardX's framing (u64
    length, masked CRC of it, data, masked CRC of the data) of
    `Event(...).SerializeToString()`."""
    proto = Event(wall_time=1.7e9 + 0.25, step=step, summary=Summary(
        value=[Summary.Value(tag="train/loss", simple_value=value)]))
    data = proto.SerializeToString()
    want = (struct.pack("Q", len(data))
            + struct.pack("I", tbx_masked_crc32c(struct.pack("Q", len(data))))
            + data + struct.pack("I", tbx_masked_crc32c(data)))
    got = events.record(events.event(1.7e9 + 0.25, step,
                                     scalars=[("train/loss", value)]))
    assert got == want
    head = Event(wall_time=5.5, file_version="brain.Event:2")
    assert events.event(5.5, file_version="brain.Event:2") == (
        head.SerializeToString())


def _small_port_system(**kw):
    return W.small_system(log_every=16, exp_name="tb", **kw)


def _scalars(logdir):
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].startswith("events.out.tfevents.")
    acc = EventAccumulator(os.path.join(logdir, files[0]))
    acc.Reload()
    return files[0], acc


def test_tensorboard_reads_a_port_fit(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    system = _small_port_system()
    hist = system.fit(max_steps=32, quiet=True)
    name, acc = _scalars(os.path.join("logs", "synthetic", "tb"))
    assert name.split(".")[-1] == os.uname().nodename
    assert sorted(acc.Tags()["scalars"]) == sorted(TAGS)
    b = system.tcfg.batch_size
    want = {"train/loss": [h["loss"] for h in hist],
            "train/psnr": [h["psnr"] for h in hist],
            "train/rm_s": [h["rm_samples"] / b for h in hist],
            "train/vr_s": [h["vr_samples"] / b for h in hist]}
    for tag in TAGS:
        got = acc.Scalars(tag)
        assert [e.step for e in got] == [h["step"] for h in hist] == [16, 32]
        np.testing.assert_array_equal(
            np.float32([e.value for e in got]), np.float32(want[tag]))


@dataclasses.dataclass(frozen=True)
class JaxSmallConfig(JaxTrainConfig):
    n_levels: int = 4
    log2_hashmap_size: int = 12

    def ngp_config(self):
        return dataclasses.replace(super().ngp_config(), grid_size=W.G)


def test_same_tags_steps_and_directory_as_jax(tmp_path, monkeypatch):
    """Both fits of 32 steps, logging every 16, on the same config: one
    event file each in logs/synthetic/tb, the same four tags, each at steps
    16 and 32 (the first block's log, as the port's, at its end)."""
    kw = {k: v for k, v in W.FIT.items()}
    kw.update(log_every=16, exp_name="tb")
    for pkg in ("jax", "port"):
        os.makedirs(tmp_path / pkg)
        monkeypatch.chdir(tmp_path / pkg)
        if pkg == "jax":
            system = JaxSystem(
                JaxSmallConfig(**kw, num_devices=1),
                train_dataset=JaxSynthetic(split="train", img_size=24,
                                           n_train=2),
                test_dataset=JaxSynthetic(split="test", img_size=24,
                                          n_test=1))
        else:
            system = _small_port_system()
        system.fit(max_steps=32, quiet=True)
        if pkg == "jax":
            system._writer.close()       # tensorboardX flushes on close
    logs = [_scalars(tmp_path / pkg / "logs" / "synthetic" / "tb")[1]
            for pkg in ("jax", "port")]
    assert sorted(logs[0].Tags()["scalars"]) == sorted(
        logs[1].Tags()["scalars"]) == sorted(TAGS)
    for tag in TAGS:
        assert [e.step for e in logs[0].Scalars(tag)] == [
            e.step for e in logs[1].Scalars(tag)] == [16, 32]


def test_two_ranks_write_one_file_from_rank_0(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    parallel.launch(W.log_fit, 2, (), device="cpu", store_dir=str(tmp_path))
    hist = torch.load(tmp_path / "history.pt", weights_only=False)
    _, acc = _scalars(tmp_path / "logs" / "synthetic" / "ddp")
    got = acc.Scalars("train/loss")
    assert [e.step for e in got] == [h["step"] for h in hist] == [16, 32]
    np.testing.assert_array_equal(np.float32([e.value for e in got]),
                                  np.float32([h["loss"] for h in hist]))
