"""The port's dry run of the hybrid family: ``lower_one("recurrentgemma-9b",
"train_4k")`` on the fake 256-rank (32, 8) H100 mesh meets
``test_torch_dryrun.check_lower_one``.  Its own file, so that this case
(about a minute: its four microbatches a run, each through the RG-LRU's
associative scan, on fake tensors) runs beside the other dry runs."""

import pytest
import torch

from test_torch_dryrun import check_lower_one


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.mark.parametrize("arch,shape", [("recurrentgemma-9b", "train_4k")])
def test_lower_one_reports_on_the_h100_mesh(arch, shape):
    check_lower_one(arch, shape)
