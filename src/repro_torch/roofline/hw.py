"""The card the port runs on: one NVIDIA H100 80GB HBM3 (SXM, 700 W).

It replaces the reference's TPU v5e table (``src/repro/roofline/hw.py``).
Rates are the published dense peaks of the SXM part, but one:
``MMA_SYNC_TF32_FLOPS`` is what the ``mma.sync`` TF32 instruction the
3xTF32 kernels issue reached on this card (``tools/mma_sync_peak.py``);
the published TF32 peak is what ``wgmma`` reaches. A card set below 700
W runs slower under load than these rates say.

``LINK_BW`` is one NVLink 4 direction of the card (450 GB/s of its 900
GB/s). The production meshes, (16, 16) and (2, 16, 16), span many
8-card nodes, so their collectives cross the slower inter-node network
too: priced at ``LINK_BW``, the collective term is a lower bound there.
"""

CARD = "NVIDIA H100 80GB HBM3"
POWER_LIMIT_W = 700

HBM_BW = 3.35e12                  # bytes/s, HBM3
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, bf16 tensor cores, dense
PEAK_FLOPS_TF32 = 494.7e12        # FLOP/s, TF32 tensor cores, dense
PEAK_FLOPS_F32 = 67e12            # FLOP/s, f32 outside the tensor cores
MMA_SYNC_TF32_FLOPS = 310.5e12    # FLOP/s, mma.sync TF32 as measured here
LINK_BW = 450e9                   # bytes/s, one NVLink 4 direction
HBM_BYTES = 85_017_493_504        # torch.cuda.get_device_properties().total_memory
