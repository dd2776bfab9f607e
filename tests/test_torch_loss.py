"""The uniform decoder's ``loss_fn`` (dense, MoE with drops, Arctic's
dense residual, Qwen2-VL's M-RoPE with text ids and an image grid)
against the JAX package's: the loss, the metrics and every gradient leaf
(tests/torch_loss_cases.py states the tolerances)."""

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
    "granite-3-2b": ("granite-3-2b", {}, True, 8, None),
    "deepseek-r1": ("deepseek-r1", {}, True, 8, None),
    "deepseek-r1, no remat, one CE chunk": ("deepseek-r1", {}, False, 512,
                                            None),
    "arctic-480b": ("arctic-480b", {}, True, 8, None),
    "qwen2-vl-2b": ("qwen2-vl-2b", {}, True, 8, None),
    "qwen2-vl-2b, image grid": ("qwen2-vl-2b", {}, True, 8, (3, 2, 4)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_loss_fn_and_every_gradient_match_the_reference(case):
    check_loss_case(*CASES[case])
