"""Pretty-print the block-segment tree of a scene file (reference:
examples/parse.rs).

    python -m curry_pbrt_tpu_torch.examples.parse scene.pbrt
"""

import sys

from curry_pbrt_tpu_torch.sceneio.parser import BlockSegment, read_scene


def dump(seg: BlockSegment, indent=0):
    pad = "  " * indent
    if seg.is_block:
        print(f"{pad}{seg.block_type}Begin {seg.block_name or ''}")
        for c in seg.children:
            dump(c, indent + 1)
        print(f"{pad}{seg.block_type}End")
    else:
        props = []
        for p in seg.properties.props:
            if p.type_name:
                vals = " ".join(str(t.value) for t in p.values[:6])
                more = " ..." if len(p.values) > 6 else ""
                props.append(f'"{p.type_name} {p.name}" [{vals}{more}]')
            else:
                props.append(" ".join(repr(t.value) for t in p.values[:6]))
        print(f"{pad}{seg.object_type} {' '.join(props)}")


def main(argv=None):
    path = (sys.argv[1:] if argv is None else argv)[0]
    for seg in read_scene(path):
        dump(seg)


if __name__ == "__main__":
    main()
