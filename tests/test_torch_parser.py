"""The port's scene-file front end (curry_pbrt_tpu_torch/sceneio/lexer.py,
parser.py, spd.py) against tests/test_parser.py, test for test, and against
the JAX package's lexer and parser on every scene of scenes/.

Token streams and segment trees are integer and string data: they must be
identical (compared as nested tuples, since the two packages' dataclasses
are distinct types). The SPD conversions carry the JAX test's own
tolerances; the port's table is a copy of the JAX package's, so its values
are also held equal to the JAX ones.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from curry_pbrt_tpu.sceneio import lexer as JL
from curry_pbrt_tpu.sceneio import parser as JP
from curry_pbrt_tpu.sceneio import spd as jspd
from curry_pbrt_tpu_torch.sceneio import spd
from curry_pbrt_tpu_torch.sceneio.lexer import tokenize_file, tokenize_string
from curry_pbrt_tpu_torch.sceneio.parser import (
    find_block,
    find_segment,
    read_scene,
    segments_from_tokens,
)
from tests.test_golden import REF_SPHERE  # the reference's scenes, where mounted

SCENES = sorted((Path(__file__).resolve().parents[1] / "scenes").glob("*.pbrt"))


class TestLexer:
    def test_basic_tokens(self):
        toks = tokenize_string('Camera "perspective" "float fov" [37.5]')
        assert [t.kind for t in toks] == ["type", "string", "string", "array"]

    def test_comments_and_numbers(self):
        toks = tokenize_string("Translate 1 -2.5 3e2 # comment\nRotate 90 0 0 1")
        assert [t.kind for t in toks] == ["type", "int", "float", "float", "type",
                                         "int", "int", "int", "int"]
        assert toks[3].value == 300.0

    def test_block_markers(self):
        toks = tokenize_string("WorldBegin AttributeBegin AttributeEnd WorldEnd")
        assert [(t.kind, t.value) for t in toks] == [
            ("block_begin", "World"), ("block_begin", "Attribute"),
            ("block_end", "Attribute"), ("block_end", "World"),
        ]

    def test_include_splices(self, tmp_path):
        (tmp_path / "inc.pbrt").write_text('Material "matte" "rgb Kd" [1 0 0]')
        main = tmp_path / "main.pbrt"
        main.write_text('WorldBegin\nInclude "inc.pbrt"\nWorldEnd\n')
        toks = tokenize_file(main)
        assert "Material" in [t.value for t in toks if t.kind == "type"]
        assert [dataclasses.astuple(t) for t in toks] == [
            dataclasses.astuple(t) for t in JL.tokenize_file(main)]

    def test_unpaired_errors(self):
        with pytest.raises(ValueError):
            tokenize_string('"unclosed')
        with pytest.raises(ValueError):
            tokenize_string("]")


class TestSegments:
    def test_nested_blocks(self):
        segs = segments_from_tokens(
            tokenize_string('WorldBegin AttributeBegin Material "matte" AttributeEnd WorldEnd'))
        world = find_block(segs, "World")
        assert world is not None
        inner = world.children[0]
        assert inner.block_type == "Attribute"
        assert inner.children[0].object_type == "Material"

    def test_named_block(self):
        segs = segments_from_tokens(
            tokenize_string('WorldBegin ObjectBegin "thing" ObjectEnd WorldEnd'))
        obj = find_block(segs, "World").children[0]
        assert obj.block_type == "Object" and obj.block_name == "thing"

    def test_property_set(self):
        segs = segments_from_tokens(tokenize_string(
            'Film "image" "string filename" ["out.png"] '
            '"integer xresolution" [640] "integer yresolution" [480]'))
        ps = segs[0].properties
        assert ps.get_name() == "image"
        assert ps.get_string("filename") == "out.png"
        assert ps.get_int("xresolution") == 640
        assert ps.get_int("yresolution") == 480
        assert ps.get_int("missing", 7) == 7

    def test_bare_floats(self):
        segs = segments_from_tokens(tokenize_string("LookAt 1 2 3 4 5 6 7 8 9"))
        assert segs[0].properties.bare_floats() == [1, 2, 3, 4, 5, 6, 7, 8, 9]

    def test_mismatched_block_end(self):
        with pytest.raises(ValueError):
            segments_from_tokens(tokenize_string("WorldBegin AttributeEnd"))

    def test_reference_scenes_parse(self):
        for name in ("cornel_box.pbrt", "sphere.pbrt"):
            p = REF_SPHERE.parent / name
            if not p.exists():
                pytest.skip("reference not mounted")
            segs = read_scene(p)
            assert find_block(segs, "World") is not None
            assert find_segment(segs, "Camera") is not None


@pytest.mark.parametrize("path", SCENES, ids=[p.name for p in SCENES])
def test_scene_tokens_and_tree_equal_jax(path):
    """Every shipped scene: the port's token stream and block-segment tree
    equal the JAX package's, value for value."""
    toks = tokenize_file(path)
    jtoks = JL.tokenize_file(path)
    assert [dataclasses.astuple(t) for t in toks] == [dataclasses.astuple(t) for t in jtoks]
    segs, jsegs = read_scene(path), JP.read_scene(path)
    assert [dataclasses.astuple(s) for s in segs] == [dataclasses.astuple(s) for s in jsegs]
    assert find_block(segs, "World") is not None


class TestSPD:
    def test_constant_spd_is_grayish(self):
        rgb = spd.spd_to_rgb([400.0, 1.0, 700.0, 1.0])
        assert np.all(np.abs(rgb - 1.0) < 0.25), rgb
        assert abs(spd.luminance(rgb) - 1.0) < 0.01
        np.testing.assert_array_equal(rgb, jspd.spd_to_rgb([400.0, 1.0, 700.0, 1.0]))

    def test_red_spd(self):
        pairs = [400, 0.0, 580, 0.0, 620, 1.0, 700, 1.0]
        rgb = spd.spd_to_rgb(pairs)
        assert rgb[0] > 3 * abs(rgb[1])
        np.testing.assert_array_equal(rgb, jspd.spd_to_rgb(pairs))

    def test_cie_y_integral_reasonable(self):
        assert abs(spd.CIE_Y_INTEGRAL - 106.857) / 106.857 < 0.02
        assert spd.CIE_Y_INTEGRAL == jspd.CIE_Y_INTEGRAL

    def test_luminance_of_white(self):
        rgb = spd.spd_to_rgb([360.0, 1.0, 830.0, 1.0])
        assert abs(spd.luminance(rgb) - 1.0) < 0.01
