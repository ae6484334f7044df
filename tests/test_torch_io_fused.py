"""Checkpoint format parity on the kernel-eligible config (``KERNEL_CFG``,
d_ff 256, whose 4-bit leaves take the fused route) and the restores that
refuse a structure mismatch; the helpers and the micro config's cases are
``tests/test_torch_io.py``'s (see its docstring)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro_torch.core.optimizers import make_optimizer  # noqa: E402
from repro_torch.io import restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.launch.train import abstract_train_state  # noqa: E402
from repro_torch.models import init_model  # noqa: E402
from repro_torch.train.train_loop import make_train_state  # noqa: E402
from test_torch_io import cfgs, checkpoint_bytes_match_reference, OPT_IDS, OPTIMIZERS  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("d_ff", [256], ids=["kernel"])
@pytest.mark.parametrize("name,ov", OPTIMIZERS, ids=OPT_IDS)
def test_checkpoint_bytes_match_reference(name, ov, d_ff, tmp_path):
    """The kernel-eligible config's case of ``checkpoint_bytes_match_reference``."""
    checkpoint_bytes_match_reference(name, ov, d_ff, tmp_path)


@pytest.mark.parametrize("saved,target", [
    (("adamw4bit", {}), ("adamw32", {})),
    (("adamw4bit", {}), ("adamw4bit", {"stochastic_rounding": True})),
    (("sgdm4bit", {}), ("sgdm", {})),
], ids=["adamw4bit_into_adamw32", "rtn_into_sr", "sgdm4bit_into_sgdm"])
def test_restore_rejects_structure_mismatch(saved, target, tmp_path):
    """The manifest records the state's structure, quantizer configs
    included: an RTN checkpoint does not restore into an SR target."""
    _, cfg = cfgs()
    model = init_model(cfg, device="cpu")
    state = make_train_state(model, make_optimizer(saved[0], 1e-3, **saved[1]))
    d = str(tmp_path / "c")
    save_checkpoint(d, 1, state)
    _, wrong = abstract_train_state(cfg, make_optimizer(target[0], 1e-3, **target[1]))
    with pytest.raises(ValueError, match="structure mismatch"):
        restore_checkpoint(d, wrong, device="cpu")
