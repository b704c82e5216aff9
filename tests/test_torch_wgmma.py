"""What the CPU can hold of the wgmma conv and GEMM: which kernel and tile a
shape takes (a pure function of the shapes), the orientation of the taps
and of the zero-filled border on one-hot boards, and that the new
boards-per-CTA values take the plain version on a CPU tensor and count no
launch. The kernels themselves run in tests/test_torch_cuda.py, on the same
one-hot inputs.

The one-hot boards hold a single 1 and the weights small integers that
differ per tap, all exact in bf16, so the JAX Pallas kernel (interpreted, as
tests/test_torch_ops.py runs it), the port's plain version and the taps
laid out by hand must be equal; the bound is 1e-6 in f32 terms.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keisei_tpu.ops.conv3x3 import conv3x3_hwbc as jax_conv3x3
from keisei_tpu_torch.ops import conv3x3 as ops
from keisei_tpu_torch.ops.conv3x3 import (BOARDS_PER_CTA, WGMMA_BOARDS, ConvRoute, conv3x3_bpc,
                                          conv3x3_hwbc, conv3x3_hwbc_reference, conv_route,
                                          wgmma_tile)
from keisei_tpu_torch.scripts import profile_conv_alternatives as alt
from keisei_tpu_torch.scripts import profile_direct_conv as direct
from keisei_tpu_torch.scripts.debug_fused_block import B as STAGE_B, C as STAGE_C

torch.set_num_threads(2)

MMA_SYNC = "mma_sync"
PADDED = "wgmma_padded"
REFUSED = ("refused",)   # conv_route raises: no kernel takes the output width


@pytest.mark.parametrize("n,cin,cout,want", [
    # the 50 observation planes (b40c256) at the smoke's and the profile's N: the
    # wgmma kernel after a zero pad to 64 channels, on the tile Cin = 64 takes
    (64, 50, 256, (PADDED, 64, 256)), (256, 50, 256, (PADDED, 64, 256)),
    (1024, 50, 256, (PADDED, 128, 256)), (64, 46, 256, (PADDED, 64, 256)),
    (64, 50, 128, (PADDED, 64, 128)),
    # the trunk's convs: 64 boards while the tiles are few waves, 128 beyond
    (1, 256, 256, ("wgmma", 64, 256)), (64, 256, 256, ("wgmma", 64, 256)),
    (65, 256, 256, ("wgmma", 64, 256)), (256, 256, 256, ("wgmma", 64, 256)),
    (512, 256, 256, ("wgmma", 64, 256)), (513, 256, 256, ("wgmma", 128, 256)),
    (direct.B, direct.C, direct.C, ("wgmma", 128, 256)),
    (direct.CHECK_B, direct.C, direct.C, ("wgmma", 64, 256)),
    # b10c128's width, and the stage harness's shape
    (64, 128, 128, ("wgmma", 64, 128)), (128, 128, 128, ("wgmma", 64, 128)),
    (129, 128, 128, ("wgmma", 128, 128)), (STAGE_B, STAGE_C, STAGE_C, ("wgmma", 64, 128)),
    (200, 64, 256, ("wgmma", 64, 256)), (1024, 64, 128, ("wgmma", 128, 128)),
    # other output widths are refused, not routed to a kernel that refuses; any Cin pads
    (8, 32, 32, REFUSED), (8, 96, 256, (PADDED, 64, 256)),
    (8, 64, 64, REFUSED),
])
def test_conv_route(n, cin, cout, want):
    if want == REFUSED:
        with pytest.raises(ValueError, match="Cout"):
            conv_route(n, cin, cout)
        return
    route = conv_route(n, cin, cout)
    assert (route.kernel, route.boards, route.cout_tile) == want
    assert route.persistent and route.kernel != MMA_SYNC
    assert (cin % 64 == 0) == (route.kernel == "wgmma")
    assert cout % route.cout_tile == 0 and route.boards in WGMMA_BOARDS


@pytest.mark.parametrize("boards", WGMMA_BOARDS)
@pytest.mark.parametrize("n,cout", [(7, 256), (8, 128), (1024, 256), (1024, 128)])
def test_wgmma_tile_keeps_a_requested_height(boards, n, cout):
    """conv3x3_bpc's 64 and 128 fix the tile's height; a CTA covers all of Cout."""
    assert wgmma_tile(n, cout, boards) == ConvRoute("wgmma", boards, cout, True)


def test_boards_per_cta_lists_both_kernels():
    assert BOARDS_PER_CTA == (1, 2, 4, 64, 128) and WGMMA_BOARDS == (64, 128)
    assert direct.WGMMA_TILES == tuple((b, c) for b in WGMMA_BOARDS for c in (128, 256))


@pytest.mark.parametrize("channel", [0, 63])
@pytest.mark.parametrize("name", list(direct.ONE_HOT_SQUARES))
def test_one_hot_taps_match_pallas(name, channel):
    square = direct.ONE_HOT_SQUARES[name]
    x, w = direct.one_hot_inputs(square, n=5, board=2, cin=64, cout=128, channel=channel)
    want = direct.one_hot_expected(square, w, 5, 2, channel)
    assert int((want != 0).any(-1).sum()) == {"corner": 4, "far_corner": 4, "edge": 6,
                                              "centre": 9}[name]
    conv3x3_hwbc.launches = 0
    conv3x3_hwbc.route_launches.clear()
    got = conv3x3_hwbc(x, w)
    assert conv3x3_hwbc.launches == 0 and not conv3x3_hwbc.route_launches
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    jw = jnp.asarray(w.float().numpy()).astype(jnp.bfloat16)
    ref = np.asarray(jax_conv3x3(jx, jw, batch_tile=5, interpret=True).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), rtol=0, atol=1e-6)


def test_one_hot_taps_are_distinct():
    """Every tap of the one-hot weights differs from every other at every
    (channel, output), so a swapped or mirrored tap cannot pass."""
    _, w = direct.one_hot_inputs((4, 4), cin=64, cout=128)
    taps = w.float().reshape(9, 64, 128)
    for a in range(9):
        for b in range(a + 1, 9):
            assert bool((taps[a] != taps[b]).all())
    assert torch.equal(w.float(), w.float().round()) and float(w.float().max()) < 256


@pytest.mark.parametrize("bpc", WGMMA_BOARDS)
@pytest.mark.parametrize("b,cin,cout", [(3, 64, 128), (7, 128, 256), (2, 50, 32)])
def test_wgmma_boards_per_cta_take_the_plain_version_on_cpu(bpc, b, cin, cout):
    g = torch.Generator().manual_seed(bpc + cin)
    x = torch.randn(9, 9, b, cin, generator=g).to(torch.bfloat16)
    w = (torch.randn(3, 3, cin, cout, generator=g) / (9 * cin) ** 0.5).to(torch.bfloat16)
    conv3x3_bpc.launches.clear()
    got = conv3x3_bpc(x, w, boards_per_cta=bpc)
    assert not conv3x3_bpc.launches
    assert torch.equal(got, conv3x3_hwbc_reference(x, w))


def test_conv3x3_bpc_refuses_other_heights():
    x = torch.zeros(9, 9, 2, 64, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 64, 128, dtype=torch.bfloat16)
    for bad in (0, 3, 8, 32, 256):
        with pytest.raises(ValueError, match="boards_per_cta"):
            conv3x3_bpc(x, w, boards_per_cta=bad)


@pytest.mark.parametrize("route", [ConvRoute("wgmma", 64, 256, True),
                                   ConvRoute(MMA_SYNC, 1, 256, False)])
def test_launchers_refuse_a_cpu_tensor(route):
    """Only the wrappers choose the plain version; a launcher handed a CPU
    tensor raises instead of computing anything."""
    x = torch.zeros(9, 9, 2, 64, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 64, 256, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported device"):
        ops._launch(x, w, route)


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_tiled_mm_partial_tiles_take_the_plain_version_on_cpu(dtype):
    """M = 100, N = 136: the card test's partial tiles, here through the plain version."""
    a, bt = alt.mm_inputs(dtype, 100, 256, 136, "cpu")
    alt.tiled_mm.launches.clear()
    got = alt.tiled_mm(a, bt)
    assert not alt.tiled_mm.launches
    assert got.shape == (100, 136)
    assert torch.equal(got, alt.tiled_mm_reference(a, bt))
    alt.compare_mm(got, alt.tiled_mm_reference(a, bt))
