"""The band kernel on an NVIDIA Hopper GPU against its plain version.

Marked ``gpu``: these skip where there is no CUDA device. On a machine with
the card and without JAX, run them with
``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``
(``--noconftest`` because ``tests/conftest.py`` imports JAX).
"""

import pytest
import torch

from focused_attention_vit_tpu_torch.ops import mhla_band_roll as band

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs compute capability 9.0 (Hopper)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,s,w", [(16, 15, 7), (64, 1000, 7), (32, 577, 4),
                                   (128, 200, 16), (64, 3137, 1)])
def test_kernel_matches_plain(cuda, dtype, d, s, w):
    gen = torch.Generator(device=cuda).manual_seed(s)
    q, k, v = (torch.randn(2, 3, d, s, device=cuda, generator=gen).to(dtype)
               for _ in range(3))
    before = band.launch_count()
    got = band.roll_banded_attention(q, k, v, w)
    torch.cuda.synchronize()
    assert band.launch_count() == before + 1
    want = band.plain_banded_attention(q, k, v, w)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    else:
        # Both sides compute in f32 from the same bf16 inputs and round
        # once: at most one bf16 ulp apart above 2^-10.
        torch.testing.assert_close(got.float(), want.float(), atol=2.0 ** -16,
                                   rtol=2.0 ** -7)


def test_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros(1, 2, 16, 40, device=cuda)
    with pytest.raises(ValueError):
        band.roll_banded_attention(q, q, q[..., :20].contiguous(), 7)
    with pytest.raises(ValueError):
        band.roll_banded_attention(q, q, q, band.MAX_WINDOW + 1)
