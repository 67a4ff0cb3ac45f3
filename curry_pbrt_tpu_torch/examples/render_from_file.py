"""Render a pbrt scene file (reference: examples/render_from_file.rs).

    python -m curry_pbrt_tpu_torch.examples.render_from_file scene.pbrt [--device cuda|cpu] ...

The arguments are the port's CLI's (curry_pbrt_tpu_torch/cli.py): the
render runs on the card unless `--device cpu` is given.
"""

from curry_pbrt_tpu_torch.cli import main

if __name__ == "__main__":
    main()
