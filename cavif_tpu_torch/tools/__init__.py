"""Developer harnesses of the port (off the encoder's path):

- `dir_proto`: the fused directional-cost kernel K4 against its plain
  version, per tier, tile and reduce mode;
- `dir_ablation`: the ablation variants of the same kernel (K5);
- `pass2_cases`: inputs of the pass-2 wavefront executors (a captured
  host walk, seeded frames).
"""
