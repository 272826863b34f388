"""The port's dry run of the ssm and audio families: ``lower_one`` of
``("xlstm-1.3b", "long_500k")`` and ``("whisper-base", "train_4k")`` on
the fake 256-rank (32, 8) H100 mesh meets
``test_torch_dryrun.check_lower_one``.  A file of its own, so that these
cases run beside the other dry runs."""

import pytest
import torch

from test_torch_dryrun import check_lower_one


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.mark.parametrize("arch,shape", [("xlstm-1.3b", "long_500k"),
                                        ("whisper-base", "train_4k")])
def test_lower_one_reports_on_the_h100_mesh(arch, shape):
    check_lower_one(arch, shape)
