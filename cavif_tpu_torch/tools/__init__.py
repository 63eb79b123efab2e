"""Developer harnesses of the port (off the encoder's path):

- `dir_proto`: the fused directional-cost kernel K4 against its plain
  version, per tier, tile and reduce mode;
- `dir_ablation`: the ablation variants of the same kernel (K5).
"""
