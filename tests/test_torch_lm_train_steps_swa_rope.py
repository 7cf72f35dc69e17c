"""Three LM train steps of the PyTorch port against the JAX package's, on
the CPU, for the archs with a sliding window (h2o-danube-3-4b) and partial
RoPE (chatglm3-6b): ``tests/test_torch_lm_train_steps.py``'s runs and bar
(and its rule for gradients that are float noise, with the leaves that
need it asserted) and its one intra-op thread.
"""
import pytest

pytest.importorskip("torch")

from test_torch_lm_train_steps import (OPTIMIZERS, RUNS, jx,  # noqa: E402,F401
                                       one_thread, three_steps)


@pytest.mark.parametrize("opt", OPTIMIZERS)
@pytest.mark.parametrize("arch,microbatches", RUNS[2:4])
def test_three_train_steps_match_jax(jx, arch, microbatches, opt):  # noqa: F811
    three_steps(jx, arch, microbatches, opt)
