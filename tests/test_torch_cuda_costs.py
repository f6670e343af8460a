"""The last modules' card checks: the gradient codec on the card against
the CPU, and a training step's op count on the card against its count on
the meta device.

Every test here needs a card and skips without one; the file imports
nothing of JAX (run it on a GPU host with ``PYTHONPATH=src python -m
pytest -q tests/test_torch_cuda_costs.py``). Bounds: the codec bit for
bit (a CPU generator on both sides, so both quantize with the same
noise); the op count's flops and bytes exactly, and the flash kernel's
cost records equal to its launches.
"""

import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.models.registry import get_config, get_model, smoke_config


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_gradient_codec_card_equals_cpu(cuda):
    """The int8 codec with a CPU generator on both sides: the card's
    payloads, scales, error-feedback gradients and residuals equal the
    CPU's bit for bit (true division on both devices)."""
    from repro_torch.sharding import gradient as G

    gen = torch.Generator().manual_seed(0)
    grads = {f"w{i}": torch.randn(257, 33, generator=gen) * 10.0 ** -i
             for i in range(4)}

    def run(tree):
        res = G.init_residual(tree)
        payload, scales = G.compress_tree(
            tree, torch.Generator().manual_seed(1))
        out, res = G.error_feedback_step(
            tree, res, torch.Generator().manual_seed(2))
        mean = G.compressed_all_reduce_mean(
            tree["w0"], torch.Generator().manual_seed(3))
        return {**{f"q/{k}": v for k, v in payload.items()},
                **{f"s/{k}": v for k, v in scales.items()},
                **{f"g/{k}": v for k, v in out.items()},
                **{f"r/{k}": v for k, v in res.items()}, "mean": mean}

    card = run({k: v.to(cuda) for k, v in grads.items()})
    cpu = run(grads)
    for k, v in cpu.items():
        assert card[k].is_cuda and torch.equal(card[k].cpu(), v), k


@pytest.mark.cuda
def test_op_count_card_equals_meta(cuda):
    """One smoke-width training step counted on the card and on meta:
    flops and bytes equal, the flash kernel's records equal its
    launches."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.train.train_loop import (
        TrainConfig,
        init_state,
        make_train_step,
    )
    from repro_torch.utils.opcount import OpCounter

    cfg = smoke_config(get_config("internlm2-1.8b"))
    api = get_model(cfg)
    shape = ShapeConfig("t", seq_len=64, global_batch=4, kind="train")
    state = init_state(api, torch.Generator(device="cuda").manual_seed(0))
    batch = api.make_train_batch(shape, torch.Generator(
        device="cuda").manual_seed(1))
    step = make_train_step(api, TrainConfig(n_microbatches=2))
    launches = flash_kernel.launches
    with OpCounter() as c:
        step(state, batch)
    torch.cuda.synchronize()
    meta = run_cell("internlm2-1.8b", shape, "card", microbatches=2,
                    cfg=cfg)["counts"]
    card = c.result()
    assert card["flops"] == meta["flops"]
    assert card["bytes"] == meta["bytes"]
    calls = flash_kernel.launches - launches
    assert calls == 2 * 2 * cfg.n_layers
    assert card["kernels"]["flash_attention"]["calls"] == calls
    assert meta["kernels"]["flash_attention"]["calls"] == calls
