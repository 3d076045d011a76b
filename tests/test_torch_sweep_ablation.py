"""``oisat_tpu_torch.utils.sweep_ablation`` on the CPU: each variant's
substitutions match today's ``csrc/b_matmat.cu`` as often as they should
(so the tool cannot quietly time the kernel unchanged), a source they do
not match is refused, and without a card the tool refuses to run.  The
timings themselves come only from the card."""

import pytest
import torch

from oisat_tpu_torch.ops.kernels import _build
from oisat_tpu_torch.utils import sweep_ablation as A

SOURCE = (_build.CSRC_DIR / "b_matmat.cu").read_text()


@pytest.mark.parametrize("name", sorted(A.VARIANTS))
def test_variant_applies_to_the_kernel_source(name):
    got = A.variant_source(name, SOURCE)
    assert (got == SOURCE) == (name == "kernel")
    assert "sweep_narrow" in got and "extern \"C\"" in got


def test_variant_refuses_a_source_it_does_not_match():
    with pytest.raises(ValueError, match="one_accumulator"):
        A.variant_source("one_accumulator", SOURCE.replace("across<kFull>(lo, ", "x(", 1))
    with pytest.raises(ValueError, match="no_build"):
        A.variant_source("no_build", SOURCE.replace("const int j = 16 * ks + 2 * tq;", ""))


def test_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the tool would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        A.main([])
