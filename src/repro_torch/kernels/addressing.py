"""Block-scatter address computation for the native-layout kernel.

Matthews (arXiv:1607.00291) shows that a GEMM tile loader does not need
contiguous matrix views of its operands: it needs, per tile, the *flat
memory offsets* of the tile's elements, which are computable from the
tensor's per-mode strides alone.  TBLIS calls the resulting structure a
*block-scatter matrix* — the tile walk is regular, only the address
arithmetic changes.  On TPU the same idea lands even more simply: a
Pallas grid gets **one axis per tensor mode**, and each operand's
``BlockSpec.index_map`` selects the grid coordinates of the modes that
operand actually carries.  The hardware's block fetch then *is* the
block-scatter load — no operand is ever permuted or copied, whatever the
mode ordering (including every "exceptional" Table II case and the
degenerate shared-batch layouts).

This module holds the pure address helpers behind that lowering:
row-major stride/offset arithmetic, tile clamping/coverage, the
per-mode tile assignment for the ``"native"`` strategy, and the
index-map factory the kernel installs.  Everything here is plain Python
on ints — `tests/test_property.py` pins the invariants (flat-offset
round-trips, tile-boundary coverage, no out-of-extent addresses) with
hypothesis, in isolation from the kernel.
"""

from __future__ import annotations

__all__ = [
    "DEFAULT_TILES",
    "NATIVE_EXTRA_K_TILE",
    "row_major_strides",
    "flat_offset",
    "unflatten_offset",
    "padded_extent",
    "effective_tile",
    "num_blocks",
    "tile_origins",
    "block_index_map",
    "tile_element_offsets",
    "native_mode_tiles",
]

#: role → tile size.  u/v are the GEMM free modes (v is C's minor-most mode
#: → lane axis: 128 wide), k the contracted mode (128 for the MXU), b the
#: batch walk (1 = classic sb_gemm; >1 = a 3D brick per load).
DEFAULT_TILES = {"u": 128, "v": 128, "k": 128, "b": 1}

#: tile for contracted modes beyond the primary k (multi-mode k-groups
#: that could not be fused into one view).  Sublane-depth: deep enough
#: that small extra modes collapse to one grid step, shallow enough that
#: the A/B blocks stay a fraction of the k-tile's footprint.
NATIVE_EXTRA_K_TILE = 8


# ------------------------------------------------------------------ offsets
def row_major_strides(shape) -> tuple[int, ...]:
    """Element strides of a packed row-major tensor (minor-most last)."""
    strides = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        strides[i] = strides[i + 1] * shape[i + 1]
    return tuple(strides)


def flat_offset(coords, strides) -> int:
    """Flat element offset of ``coords`` under ``strides``."""
    return sum(c * s for c, s in zip(coords, strides))


def unflatten_offset(offset: int, shape) -> tuple[int, ...]:
    """Coordinates of a flat row-major offset (inverse of ``flat_offset``
    with ``row_major_strides(shape)``)."""
    coords = []
    for s in row_major_strides(shape):
        coords.append(offset // s)
        offset %= s
    return tuple(coords)


# -------------------------------------------------------------------- tiles
def padded_extent(dim: int, tile: int) -> int:
    """Mode extent after padding to a tile multiple.

    Dims of at most one tile stay as-is — the block simply clamps to the
    dim — so tiny modes never pay tile-sized padding.
    """
    return dim if dim <= tile else -(-dim // tile) * tile


def effective_tile(dim: int, tile: int) -> int:
    """The block edge the kernel actually uses: ``tile`` clamped to the
    mode dim.  Always divides ``padded_extent(dim, tile)`` exactly."""
    return min(dim, tile)


def num_blocks(dim: int, tile: int) -> int:
    """Grid steps along one mode: padded extent over the effective tile."""
    return padded_extent(dim, tile) // effective_tile(dim, tile)


def tile_origins(dim: int, tile: int) -> tuple[int, ...]:
    """Start offsets of every tile along one (padded) mode."""
    t = effective_tile(dim, tile)
    return tuple(range(0, padded_extent(dim, tile), t))


def block_index_map(operand_modes: str, grid_modes: str):
    """The kernel's ``BlockSpec.index_map`` for one operand.

    ``grid_modes`` orders the grid axes (output modes first, contracted
    modes innermost); the map selects, from the full grid coordinate, the
    block index of each mode the operand carries — in the operand's own
    axis order.  This is the whole "transpose": index selection, not data
    movement.
    """
    sel = tuple(grid_modes.index(m) for m in operand_modes)

    def index_map(*grid_coords):
        return tuple(grid_coords[i] for i in sel)

    return index_map


def tile_element_offsets(
    operand_modes: str,
    dims: dict,
    mode_tiles: dict,
    block_coords,
    grid_modes: str,
) -> list[int]:
    """Flat element offsets one block-scatter tile load touches.

    Model of the kernel's fetch for ``operand_modes`` at grid point
    ``block_coords`` (aligned with ``grid_modes``), against the operand's
    *padded* row-major layout.  The property tests check that, over the
    full grid, these offsets (a) stay inside the padded extents — no
    out-of-bounds read exists to predicate away — and (b) cover every
    element exactly ``∏ k-mode blocks`` times.
    """
    padded = {m: padded_extent(dims[m], mode_tiles[m]) for m in operand_modes}
    strides = row_major_strides([padded[m] for m in operand_modes])
    block = block_index_map(operand_modes, grid_modes)(*block_coords)
    spans = []
    for m, b in zip(operand_modes, block):
        t = effective_tile(dims[m], mode_tiles[m])
        spans.append(range(b * t, (b + 1) * t))
    offsets = [0]
    for span, stride in zip(spans, strides):
        offsets = [o + c * stride for o in offsets for c in span]
    return offsets


# ------------------------------------------------------- role → mode tiles
def native_mode_tiles(
    a_modes: str,
    b_modes: str,
    c_modes: str,
    dims: dict,
    tiles: dict | None = None,
) -> dict:
    """Per-mode tile table for the native-layout kernel.

    Maps the four role knobs (``u``/``v``/``k``/``b``, merged over
    :data:`DEFAULT_TILES`) onto the spec's actual modes, whatever their
    ordering:

    * C's minor-most mode rides the lane axis → the ``v`` tile;
    * the largest remaining output mode → the ``u`` tile;
    * the largest contracted mode → the ``k`` tile; further contracted
      modes (unfused multi-k groups) get :data:`NATIVE_EXTRA_K_TILE`;
    * every other output mode walks at the ``b`` tile (the batch brick —
      1 by default, >1 stages a 3D brick per load).

    Unlike :func:`repro_torch.kernels.ops.plan_roles` this never fails: there
    is no layout precondition to satisfy, because the kernel addresses
    tiles from strides instead of requiring matrix views.
    """
    role = {**DEFAULT_TILES, **(tiles or {})}
    contracted = [m for m in a_modes if m in b_modes and m not in c_modes]
    mode_tiles: dict = {}
    if c_modes:
        mode_tiles[c_modes[-1]] = role["v"]
    if contracted:
        k_prim = max(contracted, key=lambda m: dims[m])
        mode_tiles[k_prim] = role["k"]
    rest_c = [m for m in c_modes[:-1]]
    if rest_c:
        u_prim = max(rest_c, key=lambda m: dims[m])
        mode_tiles[u_prim] = role["u"]
    for m in contracted:
        mode_tiles.setdefault(m, NATIVE_EXTRA_K_TILE)
    for m in rest_c:
        mode_tiles.setdefault(m, role["b"])
    return mode_tiles
