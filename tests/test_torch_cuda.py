"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need an NVIDIA GPU with nvcc (marked `cuda`; they skip where
there is none) and import neither JAX nor the JAX package, so they run
on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q -m cuda
"""

import pytest
import torch

from omni_avsr_tpu_torch.ops.beam_attention import (
    beam_decode_attention,
    beam_decode_attention_plain,
)


@pytest.fixture
def cuda_device():
    """Decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's CUDA kernels build and run only on the card")
    return torch.device("cuda")


def _beam_case(B, K, Hq, Hkv, D, P, N, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=device).to(torch.bfloat16)

    prefix_mask = torch.rand(B, P, generator=g, device=device) < 0.8
    prefix_mask[:, 0] = True
    return dict(
        q=rn(B * K, 1, Hq, D), pk=rn(B, Hkv, P, D), pv=rn(B, Hkv, P, D),
        gk=rn(B, Hkv, K, N, D), gv=rn(B, Hkv, K, N, D),
        k_cur=rn(B * K, Hkv, D), v_cur=rn(B * K, Hkv, D),
        prefix_bias=torch.where(prefix_mask, 0.0, -1e30).float(),
        anc=torch.randint(0, K, (B, K, N), generator=g, device=device, dtype=torch.int32),
    )


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,Hq,Hkv,D,P,N,step", [
    (1, 15, 32, 8, 64, 176, 32, 0),    # serving shapes, first step
    (3, 15, 32, 8, 64, 176, 32, 17),
    (4, 15, 32, 8, 64, 176, 32, 31),   # last slot
    (2, 1, 8, 4, 128, 40, 8, 5),       # K 1, head dim 128, P not a multiple of 32
    (1, 5, 8, 8, 64, 16, 16, 16),      # MHA, step == N
])
def test_beam_attention_kernel_matches_plain(cuda_device, B, K, Hq, Hkv, D, P, N, step):
    """bf16 in and out; the kernel keeps the probabilities in f32 where the
    plain version rounds them to bf16, hence the bf16-level tolerance."""
    inp = _beam_case(B, K, Hq, Hkv, D, P, N, cuda_device, seed=step + 10 * B)
    before = beam_decode_attention.launches
    out = beam_decode_attention(**inp, step=step, num_beams=K)
    assert beam_decode_attention.launches == before + 1
    ref = beam_decode_attention_plain(**inp, step=step, num_beams=K)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
def test_beam_attention_wrapper_rejects_bad_input(cuda_device):
    inp = _beam_case(1, 3, 8, 4, 64, 16, 8, cuda_device, seed=0)
    with pytest.raises(ValueError, match="dtype"):
        beam_decode_attention(**{**inp, "q": inp["q"].float()}, step=1, num_beams=3)
    with pytest.raises(ValueError, match="contiguous"):
        beam_decode_attention(**{**inp, "gk": inp["gk"].transpose(2, 3).contiguous().transpose(2, 3)},
                              step=1, num_beams=3)
    with pytest.raises(ValueError, match="step"):
        beam_decode_attention(**inp, step=9, num_beams=3)
