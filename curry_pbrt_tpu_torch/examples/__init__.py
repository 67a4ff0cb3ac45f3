"""The port's example scripts (counterparts of the repository's examples/,
which run the JAX package). Each runs as
`python -m curry_pbrt_tpu_torch.examples.<name>`:

  render_from_file       render a scene file (the port's CLI; --device cuda by default)
  parse                  print a scene's block-segment tree
  parse_lex              print a scene's token stream
  halton_sampler         print 128 Halton 2-D samples
  concentric_sample_disk print 128 concentric disk samples
  raymond_post_effect    swirl an image: in.png → out.png
"""
