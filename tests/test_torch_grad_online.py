"""Gradients through lws_torch's plain online stage and its gs sweeps with
the color2x3 in-frame scheme against jax.grad of lws_tpu, on the CPU in
float64 (tests/test_grad.py's online and quality-knob cases; the rest of
the contract: tests/test_torch_grad.py, whose fixture and loss these
share). The online loop writes nothing that autograd saved in place: its
drain steps' zero magnitudes are a new tensor, not an assignment into the
square root's output.
"""
import torch

from test_torch_grad import check, grads

torch.set_num_threads(1)


def test_gs_quality_knobs_grad_matches_lws_tpu():
    check(*grads("batch", 2, 1.0, order="gs", inner_passes=3, inner_scheme="color2x3"))


def test_online_grad_matches_lws_tpu():
    check(*grads("online", 2, 1.0, look_ahead=2, online_iterations=2))
