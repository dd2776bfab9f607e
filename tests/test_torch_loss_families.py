"""The other families' ``loss_fn`` — gemma3 (a group of 5 local + 1
global layer and a remainder local), zamba2 (Mamba2 groups and the shared
block), rwkv6, whisper (frames in the batch) — against the JAX package's:
the loss and every gradient leaf (tests/torch_loss_cases.py states the
tolerances)."""

import pytest
import torch

from torch_loss_cases import check_loss_case


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (arch, config overrides, remat, ce_chunk, image grid)
CASES = {
    "gemma3-4b, 7 layers": ("gemma3-4b", {"num_layers": 7}, True, 8, None),
    "zamba2-2.7b": ("zamba2-2.7b", {}, True, 8, None),
    "rwkv6-7b": ("rwkv6-7b", {}, True, 8, None),
    "whisper-base": ("whisper-base", {}, True, 8, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_loss_fn_and_every_gradient_match_the_reference(case):
    check_loss_case(*CASES[case])
