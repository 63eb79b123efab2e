"""Measurement drivers and developer harnesses of the port (off the
encoder's path):

- `bench`, `bench8k`, `batch512_bench`: the repository's measurement
  drivers (bench.py, tools/bench8k.py, tools/batch512_bench.py) on the
  card: the 1 MP headline JSON line, the 7680x4320 frame, the 512 mixed
  images through both batch paths;
- `dir_proto`: the fused directional-cost kernel K4 against its plain
  version, per tier, tile and reduce mode;
- `dir_ablation`: the ablation variants of the same kernel (K5);
- `pass2_cases`: inputs of the pass-2 wavefront executors (a captured
  host walk, seeded frames);
- `ab_quality`, `bdrate`: bytes / PSNR / SSIM on the synthetic corpus and
  BD-PSNR / BD-SSIM / BD-rate against libaom (tools/ab_quality.py,
  tools/bdrate.py); `ssim_probe`, `trellis_sweep`: env-knob sweeps on
  them, each setting in a child process;
- `card_probe`, `card_probe2`: the card's round trip, transfers and the
  block search per tier, plain and on K3 (tools/tpu_probe.py,
  tools/tpu_probe2.py);
- `scale_bench`: run_pass1_batch's MP/s at 1 and 2 torch.distributed
  ranks (tools/scale_bench.py).
"""
