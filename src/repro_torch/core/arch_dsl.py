"""Declarative accelerator descriptions -> :class:`ArchSpec`.

A TeAAL-flavored frontend: an accelerator is a plain dict (every value a
JSON/TOML type — strings, numbers, lists, dicts, booleans) naming its
storage levels outermost-first, and :func:`compile_arch` lowers it to the
:class:`repro_torch.core.arch.ArchSpec` the whole mapping/cost/search stack
runs on.  Nothing here adds modeling power — the DSL is sugar over
``ArchSpec``/``StorageLevel``/``NoCSpec`` — but it makes a new zoo entry
a few declarative lines instead of hand-assembled Python:

    EYERISS = compile_arch({
        "name": "eyeriss_like",
        "levels": [
            {"name": "dram"},
            {"name": "glb", "capacity": "108KB", "bandwidth": "1GB/s",
             "energy": [["dram", [100.0]]], "sg_site": "L2"},
            {"name": "spad", "capacity": "512B",
             "energy": [["glb", [6.0, 0.3]]],
             "fanout": [12, 14],                    # 2-D PE mesh
             "noc": {"multicast": "row",            # X-bus per row
                     "reduction": "col"},           # psums down columns
             "sg_site": "L3"},
            {"name": "reg", "energy": [["spad", [0.6]], ["reg", [0.05]]]},
        ],
    })

Spelling conventions (each mirrors an ``ArchSpec`` field; see COMPAT.md
"Declarative arch frontend" for the contract):

* ``capacity`` — bytes as a number, or a BINARY-unit string:
  ``"512B"``, ``"256KB"`` (= 256*1024), ``"64MB"``, ``"2GB"``.
* ``bandwidth`` — bytes/cycle as a number, or a DECIMAL-unit rate
  string divided by the chip clock: ``"16MB/s"`` = 16e6 bytes/s ->
  ``16e6 / clock_hz`` bytes/cycle (matching Table II's convention).
* ``energy`` — ordered ``[group, [component, ...]]`` pairs, pJ/byte
  into this level (the ``EnergyGroups`` shape, as nested lists).
* ``fanout`` — an instance count, or a 2-item ``[rows, cols]`` mesh.
  A mesh is the same ``rows * cols`` instances structurally, but lets
  ``noc`` schemes resolve their fanout geometrically.
* ``noc`` — ``{"multicast": ..., "reduction": ...}``.  Each scheme is
  ``true``/``"all"`` (one copy serves everyone), ``false``/``"none"``
  (one copy per instance), ``"row"``/``"col"`` (fractional; the
  discount fanout is read off the level's mesh: a row-wise bus serves
  ``cols`` instances per copy, a column-wise one ``rows``), or an
  explicit ``[label, fanout]`` pair (e.g. ``["cluster", 8]``).
* ``word``  — datawidth of one element in this level, in BYTES
  (``1.0`` for an 8-bit store); omitted = the global 16-bit default.
* ``clock`` (top level) — Hz as a number or ``"1GHz"``/``"200MHz"``
  style string; ``mac_energy`` — pJ/MAC.

The compiled ArchSpec is indistinguishable from a hand-built one:
:func:`sparsemap_desc` re-derives the paper topology and compiles
bit-identical to ``ARCH_SPARSEMAP`` (pinned against
``tests/golden/arch_sparsemap_golden.npz``).  Register the result with
:func:`repro_torch.core.arch.register_arch` to make it a named, searchable
topology (``repro_torch.configs.archs`` defines the zoo this way).
"""
from __future__ import annotations

import re
from typing import Any, Dict, Optional, Tuple, Union

from .accel import Platform
from .arch import ArchSpec, NoCSpec, StorageLevel

Desc = Dict[str, Any]

# Capacities are storage sizes -> binary units; bandwidth strings are
# link rates -> decimal units (vendor convention, and exactly how the
# existing configs spell "16 MB/s DRAM" as ``16e6 / 1.0e9``).
_CAP_UNITS = {"B": 1.0, "KB": 1024.0, "MB": 1024.0 ** 2,
              "GB": 1024.0 ** 3}
_RATE_UNITS = {"B/S": 1e0, "KB/S": 1e3, "MB/S": 1e6, "GB/S": 1e9,
               "TB/S": 1e12}
_FREQ_UNITS = {"HZ": 1e0, "KHZ": 1e3, "MHZ": 1e6, "GHZ": 1e9}

_NUM_UNIT = re.compile(r"^\s*([0-9]+(?:\.[0-9]+)?)\s*([A-Za-z/]+)\s*$")


def _parse_unit(value: Union[str, float, int], units: Dict[str, float],
                what: str) -> float:
    """A number passes through; a string must be ``<number><unit>``."""
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        return float(value)
    if isinstance(value, str):
        m = _NUM_UNIT.match(value)
        if m and m.group(2).upper() in units:
            return float(m.group(1)) * units[m.group(2).upper()]
    raise ValueError(
        f"cannot parse {what} {value!r}; give a number or a "
        f"'<number><unit>' string with unit in {sorted(units)}")


def parse_capacity(value: Union[str, float, int]) -> float:
    """Bytes.  String units are BINARY: ``"256KB"`` = 256 * 1024."""
    return _parse_unit(value, _CAP_UNITS, "capacity")


def parse_frequency(value: Union[str, float, int]) -> float:
    """Hz.  ``"1GHz"`` = 1e9."""
    return _parse_unit(value, _FREQ_UNITS, "clock")


def parse_bandwidth(value: Union[str, float, int],
                    clock_hz: float) -> float:
    """Bytes per CYCLE.  A bare number is already per-cycle; a rate
    string is DECIMAL bytes/s divided by the clock: ``"16MB/s"`` at 1 GHz
    -> ``0.016`` bytes/cycle."""
    if isinstance(value, str):
        return _parse_unit(value, _RATE_UNITS, "bandwidth") / clock_hz
    return _parse_unit(value, _RATE_UNITS, "bandwidth")


def _parse_energy(value: Any, level: str) -> Tuple:
    """``[[group, [comp, ...]], ...]`` -> the EnergyGroups tuple shape."""
    try:
        groups = tuple(
            (str(group), tuple(float(c) for c in comps))
            for group, comps in value)
    except (TypeError, ValueError) as e:
        raise ValueError(
            f"level {level!r}: energy must be ordered [group, "
            f"[component, ...]] pairs (pJ/byte), e.g. "
            f'[["glb", [3.5, 0.3]], ["reg", [0.05]]]; got {value!r}') \
            from e
    for group, comps in groups:
        if not comps:
            raise ValueError(
                f"level {level!r}: energy group {group!r} has no "
                f"components")
    return groups


def _parse_fanout(value: Any, level: str) \
        -> Tuple[int, Optional[Tuple[int, int]]]:
    """An int instance count, or a ``[rows, cols]`` mesh.  Returns
    ``(total_fanout, mesh_dims_or_None)``."""
    if isinstance(value, (list, tuple)):
        if len(value) != 2 or not all(
                isinstance(v, int) and v > 0 for v in value):
            raise ValueError(
                f"level {level!r}: a mesh fanout is [rows, cols] with "
                f"positive ints, got {value!r}")
        rows, cols = value
        return rows * cols, (rows, cols)
    if isinstance(value, int) and not isinstance(value, bool) \
            and value > 0:
        return value, None
    raise ValueError(
        f"level {level!r}: fanout must be a positive int or a "
        f"[rows, cols] mesh, got {value!r}")


def _parse_scheme(value: Any, mesh: Optional[Tuple[int, int]],
                  level: str, kind: str) \
        -> Tuple[Union[bool, str], Optional[float]]:
    """One NoC scheme declaration -> ``(scheme, fanout)`` NoCSpec args.

    ``true``/``"all"`` and ``false``/``"none"`` normalize to the plain
    booleans (so a desc-built arch compares equal to a hand-built one).
    ``"row"``/``"col"`` read their discount fanout off the level's mesh;
    any other fractional scheme spells it explicitly: ``[label, fanout]``.
    """
    if value is True or value == "all":
        return True, None
    if value is False or value == "none":
        return False, None
    if isinstance(value, (list, tuple)):
        if len(value) != 2 or not isinstance(value[0], str):
            raise ValueError(
                f"level {level!r}: noc {kind} pair must be "
                f"[scheme, fanout], got {value!r}")
        label, fan = value
        if label in ("all", "none"):
            raise ValueError(
                f"level {level!r}: noc {kind}={label!r} takes no fanout "
                f"(only fractional schemes carry a discount)")
        return label, float(fan)
    if value in ("row", "col"):
        if mesh is None:
            raise ValueError(
                f"level {level!r}: noc {kind}={value!r} needs a "
                f"[rows, cols] mesh fanout to resolve its discount "
                f"(or spell it explicitly as [{value!r}, fanout])")
        rows, cols = mesh
        # a row-wise bus puts one copy on each row's bus; it serves the
        # `cols` instances along that row (and vice versa)
        return value, float(cols if value == "row" else rows)
    if isinstance(value, str) and value:
        raise ValueError(
            f"level {level!r}: fractional noc {kind}={value!r} needs an "
            f"explicit discount — use [{value!r}, fanout] (only "
            f"'row'/'col' auto-resolve from a mesh)")
    raise ValueError(
        f"level {level!r}: noc {kind} must be true/'all', false/'none', "
        f"'row'/'col' (with a mesh), or [scheme, fanout]; got {value!r}")


def _parse_noc(value: Any, mesh: Optional[Tuple[int, int]],
               level: str) -> NoCSpec:
    if not isinstance(value, dict):
        raise ValueError(
            f"level {level!r}: noc must be a dict with 'multicast' / "
            f"'reduction' keys, got {value!r}")
    unknown = set(value) - {"multicast", "reduction"}
    if unknown:
        raise ValueError(
            f"level {level!r}: unknown noc keys {sorted(unknown)} "
            f"(allowed: multicast, reduction)")
    mc, mc_fan = _parse_scheme(value.get("multicast", True), mesh,
                               level, "multicast")
    red, red_fan = _parse_scheme(value.get("reduction", True), mesh,
                                 level, "reduction")
    return NoCSpec(multicast=mc, reduction=red,
                   multicast_fanout=mc_fan, reduction_fanout=red_fan)


_LEVEL_KEYS = {"name", "capacity", "energy", "fanout", "sg_site",
               "bandwidth", "word", "noc", "spatial"}
_TOP_KEYS = {"name", "levels", "mac_energy", "clock"}


def _parse_level(d: Any, clock_hz: float, outermost: bool) \
        -> StorageLevel:
    if not isinstance(d, dict) or "name" not in d:
        raise ValueError(f"each level is a dict with at least a 'name'; "
                         f"got {d!r}")
    name = d["name"]
    unknown = set(d) - _LEVEL_KEYS
    if unknown:
        raise ValueError(
            f"level {name!r}: unknown keys {sorted(unknown)} "
            f"(allowed: {sorted(_LEVEL_KEYS)})")
    if outermost:
        extra = set(d) - {"name"}
        if extra:
            raise ValueError(
                f"the outermost (backing) level {name!r} has no fill "
                f"edge; it takes only 'name', got extra keys "
                f"{sorted(extra)}")
        return StorageLevel(name)
    kw: Dict[str, Any] = {}
    if "capacity" in d:
        kw["capacity_bytes"] = parse_capacity(d["capacity"])
    if "energy" in d:
        kw["fill_energy"] = _parse_energy(d["energy"], name)
    mesh: Optional[Tuple[int, int]] = None
    if "fanout" in d:
        kw["fanout"], mesh = _parse_fanout(d["fanout"], name)
    if "sg_site" in d:
        kw["sg_site"] = str(d["sg_site"])
    if "bandwidth" in d:
        kw["fill_bandwidth_bytes_per_cycle"] = parse_bandwidth(
            d["bandwidth"], clock_hz)
    if "word" in d:
        kw["word_bytes"] = float(d["word"])
    if "noc" in d:
        kw["noc"] = _parse_noc(d["noc"], mesh, name)
    if "spatial" in d:
        kw["spatial"] = bool(d["spatial"])
    return StorageLevel(name, **kw)


def compile_arch(desc: Desc) -> ArchSpec:
    """Lower a declarative accelerator description (module docstring has
    the schema) to an :class:`ArchSpec`.  Purely structural — nothing is
    registered; pass the result to :func:`repro_torch.core.arch.register_arch`
    to make it name-resolvable."""
    if not isinstance(desc, dict):
        raise ValueError(f"an arch description is a dict, got "
                         f"{type(desc).__name__}")
    unknown = set(desc) - _TOP_KEYS
    if unknown:
        raise ValueError(f"unknown description keys {sorted(unknown)} "
                         f"(allowed: {sorted(_TOP_KEYS)})")
    for key in ("name", "levels"):
        if key not in desc:
            raise ValueError(f"description needs a {key!r} key")
    clock_hz = parse_frequency(desc.get("clock", 1.0e9))
    levels = tuple(
        _parse_level(d, clock_hz, outermost=(i == 0))
        for i, d in enumerate(desc["levels"]))
    return ArchSpec(
        name=str(desc["name"]), levels=levels,
        e_mac=float(desc.get("mac_energy", 0.8)), clock_hz=clock_hz)


def sparsemap_desc(platform: Union[str, Platform] = "cloud",
                   name: Optional[str] = None) -> Desc:
    """The paper topology (Fig. 3a: DRAM -> GLB -> PE array -> MACs) as
    a declarative description, populated with a platform's Table II
    numbers.  ``compile_arch(sparsemap_desc("cloud", "sparsemap"))`` is
    bit-identical to the hand-built ``ARCH_SPARSEMAP`` (test-pinned
    against ``tests/golden/arch_sparsemap_golden.npz``)."""
    from .accel import PLATFORMS
    p = PLATFORMS[platform] if isinstance(platform, str) else platform
    return {
        "name": p.name if name is None else name,
        "clock": p.clock_hz,
        "mac_energy": p.e_mac,
        "levels": [
            {"name": "dram"},
            {"name": "glb",
             "capacity": p.glb_bytes,
             "energy": [["dram", [p.e_dram_per_byte]]],
             "sg_site": "L2",
             "bandwidth": p.dram_bytes_per_cycle},
            {"name": "pebuf",
             "capacity": p.pe_buffer_bytes,
             "energy": [["glb", [p.scaled_glb_energy(),
                                 p.e_noc_per_byte]]],
             "fanout": p.n_pe,
             "sg_site": "L3",
             "spatial": True},
            {"name": "reg",
             "energy": [["pebuf", [p.scaled_pebuf_energy()]],
                        ["reg", [p.e_reg_per_byte]]],
             "fanout": p.macs_per_pe,
             "spatial": True},
        ],
    }
