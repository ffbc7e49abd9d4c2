"""The port's CNN zoo against the JAX package's, in structure, on the CPU:
the cell-based nets (Xception, the Inceptions, the DenseNets, the NASNets).
The checks are those of ``test_torch_zoo_structure.py``; the nets are split
over the two files so that two workers share the JAX builds."""

import pytest

from repro.models import cnn_zoo as jzoo

from test_torch_zoo_structure import NETS as OTHER_NETS
from test_torch_zoo_structure import check_block_dag, check_structure

NETS = ["Xception", "InceptionV3", "InceptionResNetV2", "DenseNet121",
        "DenseNet169", "DenseNet201", "NASNetMobile", "NASNetLarge"]


def test_the_two_files_cover_the_zoo_once():
    assert sorted(NETS + OTHER_NETS) == sorted(jzoo.ZOO)


@pytest.mark.parametrize("name", NETS)
def test_zoo_net_structure_matches_jax(name):
    check_structure(name)


@pytest.mark.parametrize("name", NETS)
def test_zoo_net_block_dag_matches_jax(name):
    check_block_dag(name)
