"""Traversal-analysis tools of the port, run as
`python -m curry_pbrt_tpu_torch.tools.<name>` (on the card by default;
`--device cpu` runs the kernels' plain versions):

  workload           the per-bounce traversal workload the others share
  roofline           per-bounce tile counts, K1 time and its share of the
                     card's f32 peak
  probe_granularity  tile work per ray-group granularity G and ray order
  probe_group_kernel the A/B of K1 / K2 against the group kernel K4 and its
                     baseline
  probe_group_walk   K4 with one element taken out at a time, timed in turns
  probe_small_walk   the small-table walk with one element taken out at a time
  probe_slab_grid    the slab-grid probe P against its plain version
  probe_sort_cost    argsort + gather cost at the render chunk sizes
"""
