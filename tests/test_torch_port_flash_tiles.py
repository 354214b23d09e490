"""The flash kernels' tile tables (`ops/flash_attention.py` TILES and
DEFAULT_TILE) against the instantiations `csrc/flash_attention.cu`
dispatches to, read from the source, their shared-memory fit, and the
16-byte alignment rule of the kernels' operands. No GPU and no jax needed: a tile listed but not built
would only fail at launch on the card."""

import importlib
import re
from pathlib import Path

import pytest
import torch

from _torch_port_ranks import torch_port_worker  # noqa: F401,E402

fa = importlib.import_module(
    "distributed_model_parallel_tpu_torch.ops.flash_attention")

SOURCE = (Path(fa.__file__).resolve().parent.parent / "csrc"
          / "flash_attention.cu")
SMEM_LIMIT = 232448  # bytes of shared memory a block may have on an H100


def _built():
    src = SOURCE.read_text()
    rows = {(int(d), (int(r), int(k))) for d, r, k in
            re.findall(r"DMP_QCASE\((\d+), (\d+), (\d+)\)", src)}
    dkv = {(int(d), (int(k), int(r))) for d, k, r in
           re.findall(r"DMP_KCASE\((\d+), (\d+), (\d+)\)", src)}
    return {"flash_fwd": rows, "flash_bwd_dq": rows, "flash_bwd_dkv": dkv}


@pytest.mark.parametrize("dh", fa.HEAD_DIMS)
@pytest.mark.parametrize("name", sorted(fa.TILES))
def test_listed_tiles_are_instantiated(name, dh):
    built = _built()[name]
    assert fa.TILES[name][dh], f"{name} lists no tile for Dh {dh}"
    for tile in fa.TILES[name][dh]:
        assert (dh, tile) in built, f"{name} Dh {dh} tile {tile} not built"
    for dtype in fa.DTYPES:
        assert fa.DEFAULT_TILE[name][dtype][dh] in fa.TILES[name][dh]


def test_every_instantiated_tile_is_listed():
    for name, built in _built().items():
        listed = {(dh, t) for dh in fa.HEAD_DIMS for t in fa.TILES[name][dh]}
        assert built == listed, name


@pytest.mark.parametrize("dh", fa.HEAD_DIMS)
def test_row_tiles_fit_in_shared_memory(dh):
    """K1/K2 shared memory (csrc `smem_bytes`): the resident rows (q, and
    dO for K2), 2-stage K and V rings, rows padded by 16 bytes, and for
    f32 the p / dS tile; the static key-mask bytes beside it."""
    for rows, keys in fa.TILES["flash_bwd_dq"][dh]:
        assert rows % 16 == 0 and keys % 16 == 0 and keys <= 2 * rows
        for esize in (4, 2):
            ld = dh + 16 // esize
            p_tile = rows * (keys + 4) * 4 if esize == 4 else 0
            for resident in (1, 2):  # K1, K2
                nbytes = (resident * rows + 4 * keys) * ld * esize + p_tile
                assert nbytes + keys <= SMEM_LIMIT, (dh, rows, keys, esize)


@pytest.mark.parametrize("dh", fa.HEAD_DIMS)
def test_dkv_tiles_fit_in_shared_memory(dh):
    """K3 shared memory (csrc `dkv_smem_bytes`): the block's K and V rows,
    a 2-stage ring of q and dO tiles, rows padded by 16 bytes, for f32
    the p and dS tiles (keys x (rows + 4)); beside it the static LSE and
    delta stages (2 x rows f32 each). rows <= 2 * keys: one thread a q
    row loads its stats."""
    for keys, rows in fa.TILES["flash_bwd_dkv"][dh]:
        assert keys % 16 == 0 and rows % 16 == 0 and rows <= 2 * keys
        for esize in (4, 2):
            ld = dh + 16 // esize
            p_tiles = 2 * keys * (rows + 4) * 4 if esize == 4 else 0
            nbytes = (2 * keys + 4 * rows) * ld * esize + p_tiles
            assert nbytes + 2 * 2 * rows * 4 <= SMEM_LIMIT, (dh, keys, rows,
                                                             esize)


def test_alignment_rule():
    fa._check_aligned("k", torch.zeros(2, 8, 2, 32))
    qkv = torch.zeros(2, 8, 3 * 2 * 16, dtype=torch.bfloat16)
    for x in qkv.split(32, dim=-1):  # a fused projection's split
        fa._check_aligned("k", x.view(2, 8, 2, 16))
    # a length-1 batch axis: its stride is never used
    fa._check_aligned("k", torch.zeros(512).as_strided((1, 8, 2, 32),
                                                      (3, 64, 32, 1)))
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa._check_aligned("k", torch.zeros(513)[1:].view(1, 8, 2, 32))
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa._check_aligned("k", torch.zeros(1, 8, 2, 33)[..., :32])
