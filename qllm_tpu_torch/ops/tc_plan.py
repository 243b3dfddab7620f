"""How the decode GEMVs on the tensor-core body (csrc/stacked_mma.cuh)
split K: K9 ``gptq_gemv`` and K12 ``gptq_w4a8_gemv`` (ops.qmm2d), K14 /
K15 / K16 (ops.qmm_stacked) and K8 ``w4_grouped_gemv`` (ops.qmm); and the
scale dtypes their C entry points read."""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["PARAM_TYPES", "TC_TARGET_BLOCKS", "tc_splits", "tc_group_splits"]

# scales / zeros dtypes the kernels read, by the code the C entry points take
PARAM_TYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# The blocks of 128 output columns a launch may hold, by the body's word
# layout: as many as the H100's 132 SMs hold at M <= 8 (four an SM on
# GPTQ-order words, K9 / K12 / K14 / K15, and on planar words, K8; three on
# bit-plane words, K16: its registers), so the grid runs in one wave. For
# K9, 528 ran fastest of 264-1056 at three of its four 7B shapes
# (chip_stacked_ab.py --parts k9_targets).
TC_TARGET_BLOCKS = {"gptq": 4 * 132, "bitplane": 3 * 132, "planar": 4 * 132}
BLOCK_COLS = 128
MIN_UNITS = 16  # the fewest word rows (GPTQ order, planar) or words a plane (K16) a split takes


def tc_splits(units: int, N: int, target: int, row_blocks: int = 1) -> Tuple[int, int]:
    """(splits, units per split) for a layer of ``units`` word rows (GPTQ
    order, planar) or words a plane (K16) and N columns: the most splits
    whose blocks stay within ``target`` (an entry of TC_TARGET_BLOCKS).
    ``row_blocks``: blocks along the rows (K8: a fixed count of head
    blocks). It depends on the weight's shape alone, so a row's sums never
    depend on M; the splits cover the units, the last one shorter."""
    blocks = -(-N // BLOCK_COLS) * row_blocks
    splits = max(1, min(target // blocks, units // MIN_UNITS))
    per = -(-units // splits)
    return -(-units // per), per


def tc_group_splits(units: int, N: int, target: int, group_units: int) -> Tuple[int, int]:
    """``tc_splits`` with each split widened to whole groups of
    ``group_units`` units (K12 takes a whole group's zero-point term off
    after its product): from the weight's shape and group alone."""
    _, per = tc_splits(units, N, target)
    per = -(-per // group_units) * group_units
    return -(-units // per), per
