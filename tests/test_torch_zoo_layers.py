"""Each CNN zoo layer form of the port against the JAX package's, alone, at
odd sizes, on the CPU: one node per graph, weights carried from the JAX node
(``test_torch_zoo_numerics.jax_params``), the same relative norm error of
1e-5.  SAME padding at stride 2 on odd and even inputs (XLA's extra row and
column at the end), VALID padding with a remainder, the even-k stride-1 SAME
pools (the explicit-pad route), depthwise convs, and VGG's flatten -> dense
head on two images."""

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.models import cnn_zoo as jzoo

import repro_torch.core as tcore
from repro_torch.convert import zoo_params_to_torch
from repro_torch.models import cnn_zoo

from test_torch_zoo_numerics import TOL, _image, jax_params, rel


# every layer form at odd sizes, one node each: (input (H, W, C), the JAX
# node, the port's node from a ZooGraph); the even-k stride-1 SAME pools
# take the explicit-pad route, the others ceil_mode or symmetric padding
LAYER_FORMS = {
    "conv3_same_s2_odd": ((17, 17, 5),
                          lambda: jzoo._conv_node("l", 5, 8, stride=2),
                          lambda g: g.conv("l", 5, 8, stride=2)),
    "conv7_same_s2_even": ((30, 30, 3),
                           lambda: jzoo._conv_node("l", 3, 6, k=7, stride=2),
                           lambda g: g.conv("l", 3, 6, k=7, stride=2)),
    "conv3_valid_s2": ((19, 19, 3),
                       lambda: jzoo._conv_node("l", 3, 8, stride=2,
                                               padding="VALID"),
                       lambda g: g.conv("l", 3, 8, stride=2,
                                        padding="VALID")),
    "conv5_same_s1_none": ((9, 9, 4),
                           lambda: jzoo._conv_node("l", 4, 6, k=5, act=None),
                           lambda g: g.conv("l", 4, 6, k=5, act=None)),
    "dwconv3_same_s2_even": ((14, 14, 6),
                             lambda: jzoo._dw_conv_node("l", 6, stride=2),
                             lambda g: g.dw_conv("l", 6, stride=2)),
    "dwconv3_same_s2_odd": ((13, 13, 6),
                            lambda: jzoo._dw_conv_node("l", 6, stride=2),
                            lambda g: g.dw_conv("l", 6, stride=2)),
    "dwconv5_same_s1": ((11, 11, 4),
                        lambda: jzoo._dw_conv_node("l", 4, k=5),
                        lambda g: g.dw_conv("l", 4, k=5)),
    "maxpool3_same_s2_even": ((16, 16, 3),
                              lambda: jzoo._pool_node("l", 3, 2,
                                                      padding="SAME"),
                              lambda g: g.pool("l", 3, 2, padding="SAME")),
    "maxpool3_same_s2_odd": ((15, 15, 3),
                             lambda: jzoo._pool_node("l", 3, 2,
                                                     padding="SAME"),
                             lambda g: g.pool("l", 3, 2, padding="SAME")),
    "maxpool3_valid_s2": ((15, 15, 3), lambda: jzoo._pool_node("l", 3, 2),
                          lambda g: g.pool("l", 3, 2)),
    "maxpool2_valid_s2_odd": ((15, 15, 3), lambda: jzoo._pool_node("l"),
                              lambda g: g.pool("l")),
    "maxpool2_same_s1": ((7, 7, 3),
                         lambda: jzoo._pool_node("l", 2, 1, padding="SAME"),
                         lambda g: g.pool("l", 2, 1, padding="SAME")),
    "avgpool3_same_s1": ((9, 9, 3),
                         lambda: jzoo._pool_node("l", 3, 1, "avg", "SAME"),
                         lambda g: g.pool("l", 3, 1, "avg", "SAME")),
    "avgpool3_same_s2_even": ((10, 10, 3),
                              lambda: jzoo._pool_node("l", 3, 2, "avg",
                                                      "SAME"),
                              lambda g: g.pool("l", 3, 2, "avg", "SAME")),
    "avgpool2_valid_s2_odd": ((15, 15, 3),
                              lambda: jzoo._pool_node("l", kind="avg"),
                              lambda g: g.pool("l", kind="avg")),
    "avgpool2_same_s1": ((7, 7, 3),
                         lambda: jzoo._pool_node("l", 2, 1, "avg", "SAME"),
                         lambda g: g.pool("l", 2, 1, "avg", "SAME")),
    "gap": ((5, 5, 7), lambda: jzoo._gap_node("l"), lambda g: g.gap("l")),
}


@pytest.mark.parametrize("form", sorted(LAYER_FORMS))
def test_layer_form_matches_jax(form):
    shape, jax_node, make = LAYER_FORMS[form]
    jg = jcore.LayerGraph("layer")
    jg.input(jax.ShapeDtypeStruct((1, *shape), np.float32))
    jg.add(jax_node(), [0])
    jg.trace()
    tg = cnn_zoo.ZooGraph("layer", torch.device("cpu"), 0)
    tg.input(tcore.TensorSpec((1, *shape), torch.float32))
    tg.add(make(tg), [0])
    tg.trace()
    cnn_zoo.load_params(tg, zoo_params_to_torch(jax_params(jg), "cpu"))
    assert tg.nodes[1].out_spec.shape == tuple(jg.nodes[1].out_spec.shape)
    assert tg.nodes[1].flops == jg.nodes[1].flops
    x = _image(jg, seed=3)
    want = np.asarray(jg.nodes[1].apply(x))
    got = tg.nodes[1].apply(torch.from_numpy(x))
    assert got.shape == want.shape and got.is_contiguous()
    assert rel(got, want) <= TOL


def test_dense_head_matches_jax():
    """VGG's head: flatten of an NHWC tensor (H, W, C order), dense + relu,
    dense + softmax, on two images."""
    jg = jcore.LayerGraph("head")
    jg.input(jax.ShapeDtypeStruct((2, 3, 3, 8), np.float32))
    jg.add(jzoo._flatten_node(), [0])
    jg.add(jzoo._dense_node("fc", 72, 40, act="relu"), [1])
    jg.add(jzoo._dense_node("pred", 40, 10, act="softmax"), [2])
    jg.trace()
    tg = cnn_zoo.ZooGraph("head", torch.device("cpu"), 0)
    tg.input(tcore.TensorSpec((2, 3, 3, 8), torch.float32))
    tg.add(tg.flatten(), [0])
    tg.add(tg.dense("fc", 72, 40, act="relu"), [1])
    tg.add(tg.dense("pred", 40, 10, act="softmax"), [2])
    tg.trace()
    cnn_zoo.load_params(tg, zoo_params_to_torch(jax_params(jg), "cpu"))
    x = _image(jg, seed=4)
    want, got = x, torch.from_numpy(x)
    for jn, tn in zip(jg.nodes[1:], tg.nodes[1:]):
        want, got = jn.apply(want), tn.apply(got)
    assert rel(got, np.asarray(want)) <= TOL
