"""Hardware calibrations for the perf model (paper Table 4 parameters).

The paper profiles these on Ascend 910c; we provide:
  - TPU_V5E: analytic calibration from the assignment's roofline constants
    (197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s/link ICI) with standard
    achievable-fraction deratings (MXU GEMM ~85 %, attention ~60/40 %).
    Used by the cluster simulator and the roofline analysis.
  - ASCEND_910C: the paper's platform, reconstructed from public numbers
    (A100-class: ~400 TFLOP/s fp16 per chip in the 910c dual-die package ->
    ~each die ≈ A100) — used to sanity-check Figure 3 shapes.
  - cpu_measured(): fitted from timed engine runs in this container
    (benchmarks/bench_perfmodel_accuracy.py writes the fit).
"""
from __future__ import annotations

from repro_torch.core.perf_model import HardwareParams

TPU_V5E = HardwareParams(
    name="tpu_v5e",
    F_g=197e12 * 0.85,
    F_ap=197e12 * 0.60,
    F_ad=197e12 * 0.40,
    M_g=819e9 * 0.80,
    M_a=819e9 * 0.70,
    O_p=8e-3,
    O_d=4e-3,
    B_c=50e9 * 0.80,          # one ICI link direction, 80 % efficiency
    hbm_capacity=16e9,
    peak_flops=197e12,
    peak_hbm_bw=819e9,
)

ASCEND_910C = HardwareParams(
    name="ascend_910c",
    F_g=320e12 * 0.75,        # per chip (dual-die), bf16, A100-SXM class
    F_ap=320e12 * 0.55,
    F_ad=320e12 * 0.35,
    M_g=1.6e12 * 0.75,
    M_a=1.6e12 * 0.65,
    O_p=10e-3,                # paper: xLLM prefill runtime overhead
    O_d=4e-3,
    B_c=100e9,                # RDMA KV-transfer effective bandwidth
    hbm_capacity=64e9,
    peak_flops=320e12,
    peak_hbm_bw=1.6e12,
)


#: NVIDIA H100 SXM from its data sheet (989 TFLOP/s dense bf16, 3.35 TB/s
#: HBM3, 80 GB, NVLink 450 GB/s each way), derated by the same achievable
#: fractions as TPU_V5E; the dispatch overheads are TPU_V5E's too. Nothing
#: here is measured: a fit from timed runs on the card replaces it.
H100_SXM = HardwareParams(
    name="h100_sxm_datasheet",
    F_g=989e12 * 0.85,
    F_ap=989e12 * 0.60,
    F_ad=989e12 * 0.40,
    M_g=3.35e12 * 0.80,
    M_a=3.35e12 * 0.70,
    O_p=8e-3,
    O_d=4e-3,
    B_c=450e9 * 0.80,         # one NVLink direction, 80 % efficiency
    hbm_capacity=80e9,
    peak_flops=989e12,
    peak_hbm_bw=3.35e12,
)


def cpu_measured(F: float = 50e9, M: float = 10e9, O_p: float = 30e-3,
                 O_d: float = 8e-3) -> HardwareParams:
    """Container-CPU calibration; defaults are rough, the accuracy benchmark
    fits them from measured prefill/decode timings."""
    return HardwareParams(
        name="cpu", F_g=F, F_ap=F * 0.7, F_ad=F * 0.5, M_g=M, M_a=M,
        O_p=O_p, O_d=O_d, B_c=1e9, hbm_capacity=8e9, peak_flops=F,
        peak_hbm_bw=M)
