"""Two train steps of the port == the reference's, for the five
architectures ``test_torch_training.py`` does not hold (the suite runs
one file per worker, so the per-arch steps are split over two files).
Same protocol and tolerances: see ``run_two_steps`` there."""
import pytest

from repro_torch.configs import LM_ARCHS

from test_torch_training import ARCHS as FIRST_HALF
from test_torch_training import run_two_steps

ARCHS = tuple(a for a in LM_ARCHS if a not in FIRST_HALF)


@pytest.mark.parametrize("compress", [False, True], ids=["none", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_two_train_steps_match_reference(arch, compress):
    run_two_steps(arch, compress)
