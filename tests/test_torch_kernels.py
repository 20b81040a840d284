"""The one switch of the port's hand-written kernels (parseq_tpu_torch/
kernels/__init__.py): `plain()` nests, restores what was before on leaving,
by return or by an exception, and `enabled()` reads it. Each kernel's gate
is held to it in its own decision table (B1: tests/test_torch_ar_kernel.py;
B2 and B4: tests/test_torch_attention.py; B5: tests/test_torch_encoder_route.py).
"""

import subprocess
import sys

import pytest

from parseq_tpu_torch import kernels


def test_plain_nests_and_restores():
    assert kernels.enabled()
    with kernels.plain():
        assert not kernels.enabled()
        with kernels.plain():
            assert not kernels.enabled()
        assert not kernels.enabled()  # the outer context is still open
    assert kernels.enabled()


def test_plain_restores_after_an_exception():
    with pytest.raises(RuntimeError, match='inside'):
        with kernels.plain():
            with kernels.plain():
                raise RuntimeError('inside')
    assert kernels.enabled()


def test_the_switch_imports_no_op_and_no_model():
    """kernels/ sits below ops/ and models/: importing the switch loads
    neither."""
    code = ('import sys, parseq_tpu_torch.kernels; '
            'print(sorted(m for m in sys.modules if m.startswith(("parseq_tpu_torch.ops", '
            '"parseq_tpu_torch.models"))))')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True,
                         check=True).stdout
    assert out.strip() == '[]'
