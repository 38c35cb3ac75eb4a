"""Multi-host execution: distributed init, global mesh, per-host tile I/O.

The reference is a single-process, single-GPU world (one device picked at
src/main.cpp:500 via findCudaDevice; no NCCL/MPI anywhere — SURVEY.md §2.4).
This module is the replacement committed to by SURVEY.md §5
("Distributed communication backend") and BASELINE config 5: every host of a
slice joins one SPMD program via ``jax.distributed``, the device mesh spans
all processes, and XLA routes collectives over ICI within a slice / DCN
across slices — no hand-written comm layer.

Two complementary execution modes:

* **Global-SPMD** (``render_global`` / the sharded train step): ONE jitted
  program over the cross-process mesh. The rendered image comes back as a
  globally-sharded ``jax.Array``; each host touches only its addressable
  row bands and writes its own tiles (``write_local_tiles``) — the
  per-host-I/O, no-gather path. Training reuses
  ``parallel.sharding.pixel_train_step_sharded`` unchanged: a global mesh is
  just a bigger ``data`` axis, and the weight-grad psum rides ICI/DCN.

* **Independent bands** (``render_bands``): zero cross-host communication.
  Each host renders the row bands it owns (``band % n_hosts ==
  process_index`` striping) with its local fast path and writes its own
  tiles. Because rays are stateless, a failed host's bands are simply
  adopted by the survivors (``failed_hosts``) and re-rendered from the same
  camera — the elastic-recovery design of parallel/fault.py, across hosts.

Tests spawn 2 real local processes with a localhost coordinator and 4
virtual CPU devices each (tests/test_multihost.py) — the standard JAX
stand-in for multi-host hardware.
"""
from __future__ import annotations

import glob
import os
import re
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from ..models.mlp import MLPParams
from ..ops.camera import Camera
from ..utils.config import RenderConfig
from . import mesh as mesh_lib


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> None:
    """Join the distributed runtime (idempotent).

    On managed clusters all arguments may come from the environment; on CPU
    test rigs pass coordinator/num_processes/process_id explicitly. A
    single-process world (num_processes in (None-discovered 1, 1)) skips
    initialization entirely so all single-host paths stay untouched.
    """
    from jax._src import distributed as _dist  # no public is_initialized()

    if _dist.global_state.client is not None:
        return  # already initialized
    if num_processes == 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )


def global_mesh(axis_names: Sequence[str] = ("data",)) -> Mesh:
    """Mesh over ALL processes' devices (``jax.devices()`` is global after
    ``initialize``). Device order groups by process, so the ``data`` axis is
    contiguous per host → each host's image shards are contiguous row bands."""
    return mesh_lib.make_mesh(axis_names=axis_names)


def render_global(
    params: Optional[MLPParams],
    camera: Camera,
    config: RenderConfig,
    mesh: Optional[Mesh] = None,
    matcap=None,
    frame=0.0,
) -> jax.Array:
    """One cross-process SPMD render. Returns the [H, W, 4] image as a
    globally-sharded array — use ``local_tiles``/``write_local_tiles`` for
    the per-host rows, or ``gather_image`` to replicate it everywhere.

    Staged configs (march_impl="staged") run the staged fast path per shard
    (sharding.render_image_sharded_staged): every process fetches the same
    replicated stats vector, so the overflow-retry decisions stay in
    lockstep across hosts."""
    if mesh is None:
        mesh = global_mesh()
    if config.march_impl == "staged":
        from .sharding import render_image_sharded_staged

        return render_image_sharded_staged(
            params, camera, config, mesh, matcap, frame
        )
    from .sharding import render_image_sharded

    return render_image_sharded(params, camera, config, mesh, matcap, frame)


def local_tiles(rgba: jax.Array) -> List[Tuple[int, np.ndarray]]:
    """This host's addressable row bands of a globally-sharded [H, W, 4]
    image as (row_start, [rows, W, 4] host array), merged contiguous and
    sorted. Replicated/single-host arrays yield one full-image tile."""
    bands: dict[int, np.ndarray] = {}
    for shard in rgba.addressable_shards:
        row = shard.index[0]
        start = row.start or 0
        if start not in bands:  # replicated axes repeat the same slice
            bands[start] = np.asarray(shard.data)
    merged: List[Tuple[int, np.ndarray]] = []
    for start in sorted(bands):
        if merged and merged[-1][0] + merged[-1][1].shape[0] == start:
            prev_start, prev = merged.pop()
            merged.append((prev_start, np.concatenate([prev, bands[start]])))
        else:
            merged.append((start, bands[start]))
    return merged


def tile_path(out_dir: str, stem: str, row_start: int, row_stop: int) -> str:
    return os.path.join(out_dir, f"{stem}.rows{row_start:05d}-{row_stop:05d}.npy")


def write_local_tiles(rgba: jax.Array, out_dir: str, stem: str) -> List[str]:
    """Write this host's row bands as .npy tiles (no cross-host gather —
    SURVEY.md §5: per-host I/O writes its own tiles). Returns the paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for start, band in local_tiles(rgba):
        p = tile_path(out_dir, stem, start, start + band.shape[0])
        np.save(p, band)
        paths.append(p)
    return paths


_TILE_RE = re.compile(r"\.rows(\d+)-(\d+)\.npy$")


def assemble_tiles(out_dir: str, stem: str) -> np.ndarray:
    """Assemble every host's tiles of ``stem`` into one [H, W, 4] image.
    Raises if rows are missing or overlap (a host died without recovery)."""
    tiles = []
    for p in sorted(glob.glob(os.path.join(out_dir, f"{stem}.rows*.npy"))):
        m = _TILE_RE.search(p)
        if not m:
            continue
        tiles.append((int(m.group(1)), int(m.group(2)), np.load(p)))
    if not tiles:
        raise FileNotFoundError(f"no tiles for {stem!r} in {out_dir}")
    tiles.sort()
    rows = 0
    for start, stop, band in tiles:
        if start != rows:
            raise ValueError(f"tile gap/overlap at row {rows}: next tile starts {start}")
        rows = stop
    return np.concatenate([band for _, _, band in tiles], axis=0)


def gather_image(rgba: jax.Array) -> np.ndarray:
    """Replicate a globally-sharded image to every host (verification /
    display only; the production path writes per-host tiles instead)."""
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(rgba, tiled=True))


def band_owners(
    n_bands: int, n_hosts: int, failed_hosts: Sequence[int] = ()
) -> List[int]:
    """Band → host assignment: round-robin striping, with failed hosts'
    bands adopted round-robin by the survivors (rays are stateless, so
    recovery is pure recomputation — parallel/fault.py's design across
    hosts)."""
    failed = set(failed_hosts)
    survivors = [h for h in range(n_hosts) if h not in failed]
    if not survivors:
        raise ValueError("all hosts failed")
    owners = []
    takeover = 0
    for band in range(n_bands):
        h = band % n_hosts
        if h in failed:
            h = survivors[takeover % len(survivors)]
            takeover += 1
        owners.append(h)
    return owners


def render_bands(
    params: Optional[MLPParams],
    camera: Camera,
    config: RenderConfig,
    matcap=None,
    frame=0.0,
    *,
    n_bands: Optional[int] = None,
    failed_hosts: Sequence[int] = (),
    host_id: Optional[int] = None,
    n_hosts: Optional[int] = None,
) -> List[Tuple[int, np.ndarray]]:
    """Render only the row bands this host owns — ZERO cross-host
    communication (each band is an independent single-host render of a row
    slice; parallel/fault.py::_render_band, one compiled program for all
    bands). Returns [(row_start, [rows, W, 4]), ...] host arrays, ready for
    ``write_band_tiles``. Staged configs (march_impl="staged") run each
    band through the staged fast path with a dense fallback
    (fault.render_band_auto) — the per-host band path is no longer pinned
    to the round-0 dense march."""
    from .fault import render_band_auto

    if host_id is None:
        host_id = jax.process_index()
    if n_hosts is None:
        n_hosts = jax.process_count()
    if n_bands is None:
        n_bands = n_hosts
    if config.height % n_bands:
        raise ValueError(f"height {config.height} not divisible by {n_bands} bands")
    rows = config.height // n_bands
    owners = band_owners(n_bands, n_hosts, failed_hosts)
    frame = jnp.asarray(frame, jnp.float32)
    out = []
    for band, owner in enumerate(owners):
        if owner != host_id:
            continue
        rgba = render_band_auto(
            params, camera, config, matcap, frame, band, n_bands,
        )
        out.append((band * rows, rgba))
    return out


def write_band_tiles(
    bands: List[Tuple[int, np.ndarray]], out_dir: str, stem: str
) -> List[str]:
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for start, band in bands:
        p = tile_path(out_dir, stem, start, start + band.shape[0])
        np.save(p, band)
        paths.append(p)
    return paths
