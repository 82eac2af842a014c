"""The MoE decoder through the port's CLIs, on the CPU (`--device cpu`):
`--moe-experts` builds it (`cli/common.py::build_model`, as the JAX CLIs'
`omni_avsr_tpu/cli/common.py:185-188`), `train_omni --synthetic 4 --tiny`
trains it for an epoch and `eval_omni` decodes with it; int8 decode
weights of an MoE decoder are refused with the JAX package's limit named.
"""

import os

import numpy as np
import pytest
import torch

TINY = ["--num-beams", "2", "--max-dec-tokens", "4", "--whisper-input-mode", "bucket"]


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("routing", ["balanced", "top1"])
def test_build_model_moe(routing):
    from omni_avsr_tpu_torch.cli import train_omni
    from omni_avsr_tpu_torch.cli.common import build_model

    args = train_omni.parse_args(["--synthetic", "4", "--tiny", "true", "--moe-experts", "2",
                                  "--moe-routing", routing, "--moe-capacity-factor", "1.5"])
    llm = build_model(args).cfg.llm
    assert (llm.moe_experts, llm.moe_routing, llm.moe_capacity_factor) == (2, routing, 1.5)


def test_train_then_eval_moe(tmp_path, capsys):
    from omni_avsr_tpu_torch.cli import eval_omni, train_omni

    exp = tmp_path / "moe"
    train_omni.main(["--synthetic", "4", "--tiny", "true", "--moe-experts", "2",
                     "--max-epochs", "1", "--auto-test", "false", "--downsample-ratio-audio",
                     "4", "--downsample-ratio-video", "2", "--device", "cpu",
                     "--exp-dir", str(exp)] + TINY)
    out = capsys.readouterr().out
    line = next(s for s in out.splitlines() if s.startswith("epoch 0:"))
    loss = float(line.split("train_loss=")[1].split()[0])
    assert np.isfinite(loss), line
    assert os.listdir(exp / "omni" / "checkpoints") == ["step_00000001.pt"]

    res = eval_omni.main(["--synthetic", "2", "--moe-experts", "2", "--device", "cpu",
                          "--pretrained-model-path", str(exp / "omni" / "checkpoints"),
                          "--exp-dir", str(tmp_path / "eval")] + TINY)
    assert res and all(np.isfinite(v) and v >= 0 for v in res.values())
    with pytest.raises(ValueError, match=r"omni_avsr_tpu/ops/quant.py:251"):
        eval_omni.main(["--synthetic", "2", "--moe-experts", "2", "--device", "cpu",
                        "--quantize-decode", "int8", "--exp-dir", str(tmp_path / "q")] + TINY)
