"""Accelerator platform models (SparseMap §V.A, Table II).

A 3-level storage architecture: off-chip DRAM -> Global Buffer (GLB) ->
PE array (each PE with a local buffer and several MACs), Fig. 3(a).

Energy constants are 12 nm-class per-access numbers in pJ (the paper uses the
DSTC 12 nm process; absolute pJ values are config constants, not claims — see
DESIGN.md §5).  Latency model: 1 GHz clock; DRAM bandwidth from Table II.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Platform:
    name: str
    n_pe: int                  # number of PEs (spatial fanout at L2_S)
    macs_per_pe: int           # MACs per PE (spatial fanout at L3_S)
    pe_buffer_bytes: int       # per-PE local buffer
    glb_bytes: int             # global buffer
    dram_bw_bytes_per_s: float
    clock_hz: float = 1.0e9

    # --- per-access energies, pJ per byte unless noted -----------------
    e_dram_per_byte: float = 100.0      # off-chip DRAM access
    e_glb_per_byte: float = 3.0         # large on-chip SRAM
    e_pebuf_per_byte: float = 0.6       # small local SRAM
    e_reg_per_byte: float = 0.05        # register/file forwarding
    e_mac: float = 0.8                  # one 16-bit MAC op, pJ
    e_noc_per_byte: float = 0.3         # GLB <-> PE network hop

    @property
    def dram_bytes_per_cycle(self) -> float:
        return self.dram_bw_bytes_per_s / self.clock_hz

    def scaled_glb_energy(self) -> float:
        """SRAM energy grows ~sqrt(capacity); normalize to 128 KB."""
        return self.e_glb_per_byte * math.sqrt(self.glb_bytes / (128 * 1024))

    def scaled_pebuf_energy(self) -> float:
        return self.e_pebuf_per_byte * math.sqrt(self.pe_buffer_bytes / 1024)


# Table II ---------------------------------------------------------------
EDGE = Platform(
    name="edge",
    n_pe=16 * 16, macs_per_pe=1,
    pe_buffer_bytes=1 * 1024, glb_bytes=128 * 1024,
    dram_bw_bytes_per_s=16e6,
)

MOBILE = Platform(
    name="mobile",
    n_pe=16 * 16, macs_per_pe=64,
    pe_buffer_bytes=32 * 1024, glb_bytes=16 * 1024 * 1024,
    dram_bw_bytes_per_s=32e9,
)

CLOUD = Platform(
    name="cloud",
    n_pe=32 * 32, macs_per_pe=64,
    pe_buffer_bytes=128 * 1024, glb_bytes=64 * 1024 * 1024,
    dram_bw_bytes_per_s=128e9,
)

PLATFORMS = {p.name: p for p in (EDGE, MOBILE, CLOUD)}



# NVIDIA H100 SXM5 roofline constants (NVIDIA H100 Tensor Core GPU
# datasheet: dense BF16 989 TFLOP/s, HBM3 3.35 TB/s, 80 GB; fourth-
# generation NVLink 900 GB/s total = 18 links x 25 GB/s per direction).
# NVLink joins the 8 GPUs of one node; a mesh dimension wider than 8
# spans nodes, and a DGX H100 gives each GPU one 400 Gb/s ConnectX-7 port
# to the others (50 GB/s per direction).  Used by core.autoshard and the
# dry-run's roofline terms, not by the paper's cost model above.  The
# reference's TPU_V5E constants stay out of the port.
H100_SXM = dict(
    peak_bf16_flops=989e12,             # per GPU, dense
    hbm_bw_bytes_per_s=3.35e12,         # per GPU
    ici_link_bw_bytes_per_s=18 * 25e9,  # NVLink 4, all links, per direction
    inter_node_bw_bytes_per_s=50e9,     # one 400 Gb/s NIC per GPU
    gpus_per_node=8,                    # NVLink domain of one DGX H100
    hbm_bytes=80e9,                     # capacity per GPU
)
