"""The label tools' CNN codes on the card against the CPU's.

Every test here needs a CUDA device and skips without one.  The file imports
no JAX, so it runs on a GPU host without it; the suite's conftest imports
JAX, hence ``--noconftest``:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_tools.py

The extractor's float32 codes (TF32 off) on the card are within 1e-5 of
the CPU's with the same seeded weights; its bf16 codes keep a cosine of at
least 0.9995 with the float32 ones (the bounds of ``chip_smoke.py``'s tools
phase, where a crop with its pixel rows shuffled reads 0.9969).
"""

import numpy as np
import pytest
import torch

from torchfcn.tools.features import CnnCodeExtractor

pytestmark = pytest.mark.cuda

CODE_ATOL = 1e-5
MIN_COSINE = 0.9995


@pytest.fixture
def crops():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (int(h), int(w), 3), dtype=np.uint8)
            for h, w in rng.integers(20, 300, (12, 2))]


def test_float32_codes_match_cpu(crops):
    card = CnnCodeExtractor(dtype=torch.float32, device="cuda")(crops)
    cpu = CnnCodeExtractor(dtype=torch.float32, device="cpu")(crops)
    assert card.shape == (len(crops), 512)
    np.testing.assert_allclose(card, cpu, rtol=0, atol=CODE_ATOL)


def test_bf16_codes_keep_their_direction(crops):
    f32 = CnnCodeExtractor(dtype=torch.float32, device="cuda")(crops)
    bf16 = CnnCodeExtractor(dtype=torch.bfloat16, device="cuda")(crops)
    cosine = (f32 * bf16).sum(1) / np.linalg.norm(bf16, axis=1)
    assert cosine.min() >= MIN_COSINE, cosine.min()
