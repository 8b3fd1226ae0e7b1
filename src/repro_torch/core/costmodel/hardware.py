"""Hardware models.

Chips are modeled by peak dense FLOP/s, HBM bandwidth/capacity and link
bandwidths — the same abstraction the paper (and GenZ) uses.  GPU entries
reproduce the paper's case studies; TPU v5e is the real deployment target
of this repo, and the PIM entry follows the paper's GDDR6-AiM setting
(Fig. 12): a memory-centric part whose effective bandwidth, not FLOPs, is
the selling point.  ``price`` is relative to A100 = 1.0 (used by the
Fig. 12 budget analysis).

``ClusterSpec`` adds the interconnect topology between chips (GPUs per
node, intra-node vs inter-node ``LinkSpec``) and ``ParallelSpec`` the
parallelism strategy mapped onto it (tensor/pipeline degree, data
replicas) — together the hardware axes the exploration harness sweeps
(docs/PARALLELISM.md).

The port's copy of ``repro.core.costmodel.hardware``, its imports rewritten.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

from repro_torch.core.comm import DCN, ETH100G, ICI, LinkSpec, NVLINK


@dataclass(frozen=True)
class HardwareSpec:
    name: str
    flops: float            # peak dense FLOP/s (fp16/bf16 tensor)
    mem_bw: float           # HBM bytes/s
    mem_cap: float          # HBM bytes
    link_bw: float          # inter-device bytes/s (NVLink / ICI per link)
    pcie_bw: float = 32e9   # host link bytes/s
    #: host DRAM bytes available to park swapped-out KV (the SwapManager
    #: tier, docs/MEMORY.md); the per-accelerator share of the host box
    host_mem_cap: float = 256e9
    price: float = 1.0      # relative to A100
    # achievable fractions (empirical efficiency of dense kernels):
    flops_eff: float = 0.62
    bw_eff: float = 0.82
    # fixed per-iteration overhead (framework + launch), seconds
    iter_overhead: float = 4.0e-3
    #: model-reload latency after a worker restart, seconds
    #: (docs/RELIABILITY.md): weights back onto the device plus server
    #: re-init — the dominant recovery cost, and the same scale-up lag
    #: an autoscaler would pay.  Consumed only when ``SimSpec.chaos``
    #: is set; the legacy fault path keeps recovery free.
    reload_time: float = 30.0
    #: remote KV tier link (docs/ROUTING.md): effective bytes/s this
    #: host sees from the cluster object store (LMCache-class; a 50 GbE
    #: NIC share by default).  Consumed only when ``SimSpec.remote_kv``
    #: is set — per-tier retrieve cost = remote_setup + bytes/remote_bw.
    remote_bw: float = 6.25e9
    #: per-object remote-store round-trip setup latency, seconds
    #: (metadata lookup + connection + first byte)
    remote_setup: float = 2e-3

    def with_(self, **kw) -> "HardwareSpec":
        return replace(self, **kw)


A100 = HardwareSpec("A100", flops=312e12, mem_bw=2.039e12, mem_cap=80e9,
                    link_bw=300e9, price=1.0)
A100_40G = A100.with_(name="A100-40G", mem_cap=40e9)
#: the paper's "AL" — A100 with 1/4 peak FLOPS (Fig. 12)
A100_LOW = A100.with_(name="A100-low", flops=312e12 / 4, price=0.9)
V100 = HardwareSpec("V100", flops=125e12, mem_bw=0.9e12, mem_cap=32e9,
                    link_bw=150e9, pcie_bw=16e9, host_mem_cap=96e9,
                    price=0.25)
#: SK Hynix GDDR6-AiM accelerator card (paper's "G"): near-bank compute
#: gives GDDR6 an effective ~16x internal bandwidth for GEMV-like decode
#: ops. Modeled from the Hot Chips '34 figures at card level; the paper
#: prices it at ~1/2 an A100.
G6_AIM = HardwareSpec("G6-AiM", flops=26e12, mem_bw=2.0e12, mem_cap=32e9,
                      link_bw=32e9, pcie_bw=16e9, host_mem_cap=64e9,
                      price=0.5)
#: TPU v5e — the deployment target for the real runtime in this repo.
TPU_V5E = HardwareSpec("TPUv5e", flops=197e12, mem_bw=819e9, mem_cap=16e9,
                       link_bw=50e9, pcie_bw=16e9, host_mem_cap=128e9,
                       price=0.35)
#: NVIDIA L4 — the cheap inference card (Ada, 24 GB GDDR6): weak on
#: prefill FLOPs but plenty of bandwidth-per-dollar for small-model
#: decode, which is what makes the mixed A100-prefill + L4-decode
#: fleets in benchmarks/hetero_fleet.py win on $/token
L4 = HardwareSpec("L4", flops=121e12, mem_bw=300e9, mem_cap=24e9,
                  link_bw=64e9, pcie_bw=16e9, host_mem_cap=64e9,
                  price=0.2)
#: CPU host executing the real JAX engine in this container; calibrated
#: via TabularBackend, the static numbers are only a seed.  KV "swap"
#: target is its own DRAM, so pcie_bw degrades to a memcpy.
CPU_HOST = HardwareSpec("CPU", flops=2e11, mem_bw=40e9, mem_cap=32e9,
                        link_bw=10e9, pcie_bw=20e9, host_mem_cap=32e9,
                        price=0.02, flops_eff=0.5, bw_eff=0.5,
                        iter_overhead=1e-3)

HARDWARE = {h.name: h for h in
            [A100, A100_40G, A100_LOW, V100, G6_AIM, TPU_V5E, L4,
             CPU_HOST]}


# ---------------------------------------------------------------------------
# Interconnect topology + parallelism strategy (docs/PARALLELISM.md)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ClusterSpec:
    """Interconnect topology of one serving replica's devices.

    Devices are numbered consecutively; nodes hold ``gpus_per_node`` of
    them, wired internally by ``intra_link`` (NVLink / ICI class) and to
    each other by ``inter_link`` (NIC class).  The collective cost model
    (repro.core.comm.collectives) uses this to decide which link a TP
    ring or a PP stage boundary traverses, so parallelism cost depends
    on *where* the ranks land, not just how many there are.
    """
    name: str
    gpus_per_node: int = 8
    intra_link: LinkSpec = NVLINK
    inter_link: LinkSpec = ETH100G

    def with_(self, **kw) -> "ClusterSpec":
        return replace(self, **kw)


#: DGX-class box: 8 NVLinked GPUs per node, 100 GbE between nodes.
DGX_A100 = ClusterSpec("dgx-a100", gpus_per_node=8,
                       intra_link=NVLINK, inter_link=ETH100G)
#: one GPU per host — every device-to-device hop crosses the 100 GbE NIC
#: (the "slow inter-node links" corner of the TP-vs-PP crossover).
CROSS_NODE_100G = ClusterSpec("cross-node-100g", gpus_per_node=1,
                              intra_link=NVLINK, inter_link=ETH100G)
#: one GPU per host behind data-center network links (50 Gbps class).
CROSS_NODE_DCN = ClusterSpec("cross-node-dcn", gpus_per_node=1,
                             intra_link=NVLINK, inter_link=DCN)
#: TPU v5e topology: 4-chip ICI-connected trays, DCN between trays.
TPU_V5E_POD = ClusterSpec("tpuv5e-pod", gpus_per_node=4,
                          intra_link=ICI, inter_link=DCN)

CLUSTERS = {c.name: c for c in
            [DGX_A100, CROSS_NODE_100G, CROSS_NODE_DCN, TPU_V5E_POD]}


@dataclass(frozen=True)
class ParallelSpec:
    """Parallelism strategy of one logical worker (docs/PARALLELISM.md).

    ``tp`` tensor-shards every layer (all-reduce per layer pair), ``pp``
    splits the layer stack into pipeline stages fed ``microbatches``
    micro-batches per iteration, and ``replicas`` data-parallel-clones
    the whole worker set behind the global scheduler.  One worker spec
    with ``ParallelSpec(tp, pp)`` therefore occupies ``tp * pp``
    devices; the defaults are exactly the pre-parallelism single-device
    cost model.
    """
    tp: int = 1            # tensor-parallel degree (devices per stage)
    pp: int = 1            # pipeline stages
    replicas: int = 1      # data-parallel copies of the worker set
    #: micro-batches per pipeline iteration; the bubble fraction is
    #: (pp - 1) / (microbatches + pp - 1)
    microbatches: int = 2

    def __post_init__(self):
        if self.tp < 1 or self.pp < 1 or self.replicas < 1 \
                or self.microbatches < 1:
            raise ValueError(f"ParallelSpec degrees must be >= 1: {self}")

    @property
    def devices(self) -> int:
        """Accelerators one replica of this strategy occupies."""
        return self.tp * self.pp
