"""The port's checkpoints (``train/checkpoint.py``) and fault-tolerant
runner (``train/fault_tolerance.py``), on internlm2 at ``smoke_config``:
the round trip and retention, bf16 leaves stored as their bits and
restored exactly, no temporary directory left, a restored state that
trains on exactly as the uninterrupted one, and the runner recovering from
an injected failure with the JAX package's counts.
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.data.pipeline import DataConfig, TokenStream, to_device
from repro_torch.models import registry
from repro_torch.train import checkpoint as ck
from repro_torch.train.fault_tolerance import RunnerConfig, TrainRunner
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.train_loop import (
    TrainConfig,
    init_state,
    make_train_step,
)

ARCH = "internlm2-1.8b"


def _api(dtype="float32"):
    cfg = registry.smoke_config(registry.get_config(ARCH))
    return registry.get_model(dataclasses.replace(cfg, dtype=dtype))


def _stream(api):
    # 2 x 8 tokens: each op stays below the CPU's intra-op grain size, so a
    # step stays cheap beside other test processes
    stream = TokenStream(DataConfig(api.cfg.vocab, 8, 2))
    return lambda step: to_device(stream.batch(step), "cpu")


def _equal(a, b):
    la, lb = ck.state_leaves(a), ck.state_leaves(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert torch.equal(x.detach(), y.detach()), k


def test_roundtrip_and_retention(tmp_path):
    api = _api()
    state = init_state(api, torch.Generator().manual_seed(2))
    for s in (10, 20, 30):
        ck.save_checkpoint(tmp_path, state, s, keep=2)
    assert ck.latest_step(tmp_path) == 30
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_20",
                                                          "step_30"]
    target = init_state(api, torch.Generator().manual_seed(0))
    restored, step = ck.restore_checkpoint(tmp_path, target)
    assert step == 30
    _equal(restored, state)
    assert restored["params"] is not target["params"]
    assert all(p.requires_grad for p in restored["params"].parameters())
    older, step = ck.restore_checkpoint(tmp_path, target, step=20)
    assert step == 20
    _equal(older, state)


def test_bf16_leaves_exact(tmp_path):
    """A bf16 model's params cross as their 16 bits: the manifest says
    bfloat16, the npz holds uint16, the restore is bit-exact."""
    api = _api("bfloat16")
    state = init_state(api, torch.Generator().manual_seed(3))
    path = ck.save_checkpoint(tmp_path, state, 1)
    leaves = json.loads((path / "manifest.json").read_text())["leaves"]
    assert leaves["params/embedding.embed"]["dtype"] == "bfloat16"
    assert leaves["opt/master/embedding.embed"]["dtype"] == "float32"
    with np.load(path / "shard_0.npz") as z:
        assert z["params__embedding.embed"].dtype == np.uint16
    restored, _ = ck.restore_checkpoint(tmp_path, init_state(
        api, torch.Generator().manual_seed(0)), device="cpu")
    _equal(restored, state)
    assert restored["params"].embedding.embed.dtype == torch.bfloat16


def test_no_temporary_left(tmp_path):
    api = _api()
    state = init_state(api, torch.Generator().manual_seed(4))
    for s in (1, 2, 2):  # a step saved twice replaces its directory
        ck.save_checkpoint(tmp_path, state, s)
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["step_1", "step_2"]
    assert not list(tmp_path.glob(".tmp_step_*"))
    assert ck.latest_step(tmp_path / "none") is None
    with pytest.raises(FileNotFoundError):
        ck.restore_checkpoint(tmp_path / "none", state)


def test_restore_then_three_steps_equals_six(tmp_path):
    """Six straight steps, and three steps from a checkpoint taken after
    the third: the same params and optimizer state, bit for bit."""
    api = _api()
    step_fn = make_train_step(api, TrainConfig(opt=OptimizerConfig(
        lr=3e-3, warmup_steps=2, total_steps=20)))
    batch = _stream(api)
    state = init_state(api, torch.Generator().manual_seed(5))
    for i in range(3):
        state, _ = step_fn(state, batch(i))
    ck.save_checkpoint(tmp_path, state, 3)
    for i in range(3, 6):
        state, _ = step_fn(state, batch(i))
    resumed, step = ck.restore_checkpoint(
        tmp_path, init_state(api, torch.Generator().manual_seed(0)))
    for i in range(step, 6):
        resumed, _ = step_fn(resumed, batch(i))
    _equal(resumed, state)
    assert int(resumed["step"]) == 6


def test_runner_recovers_from_injected_failure(tmp_path):
    """The JAX package's case: 12 steps, a checkpoint every 4, a failure
    injected at step 6; one retry, a recovery from step 4, and the last
    checkpoint at 12."""
    api = _api()
    runner = TrainRunner(
        make_train_step(api, TrainConfig()),
        init_state(api, torch.Generator().manual_seed(4)),
        _stream(api),
        RunnerConfig(total_steps=12, checkpoint_every=4,
                     checkpoint_dir=str(tmp_path)),
        failure_at=6,
    )
    out = runner.run()
    assert out["final_step"] == 12
    assert out["retries"] == 1
    assert out["recoveries"] >= 1
    assert ck.latest_step(tmp_path) == 12
    assert int(runner.state["step"]) == 12
    assert torch.isfinite(out["metrics"]["loss"])
    assert len(runner.step_times) == 14  # steps 0-5, then 4-11 again


def test_runner_resumes_from_latest(tmp_path):
    """A second runner on the same directory resumes where the first
    stopped and runs only the remaining steps."""
    api = _api()
    step_fn = make_train_step(api, TrainConfig())
    cfg = RunnerConfig(total_steps=4, checkpoint_every=2,
                       checkpoint_dir=str(tmp_path))
    TrainRunner(step_fn, init_state(api, torch.Generator().manual_seed(6)),
                _stream(api), cfg).run()
    cfg = dataclasses.replace(cfg, total_steps=6)
    runner = TrainRunner(step_fn, init_state(
        api, torch.Generator().manual_seed(7)), _stream(api), cfg)
    out = runner.run()
    assert out["recoveries"] == 1 and out["final_step"] == 6
    assert len(runner.step_times) == 2
    assert sorted(p.name for p in pathlib.Path(tmp_path).iterdir()) == [
        "step_4", "step_6"]
