"""The port's vector entry point and the host modules beside it, on the CPU:
the copies of ``plotweave/frontends``, ``stream/manifest_creator.py``,
``demo/generator.py`` and ``utils/analysis.py`` against the G-code and
manifest goldens and against the JAX package's output on the same seeded
inputs (the counterparts of ``tests/test_frontends.py`` and of the front-end
and analysis cases of ``tests/test_tools.py``); the plain version of kernel
K14 (``ops/bezier.py``) against the JAX package's ``xp=jax.numpy`` sampling
and numpy float64; and stage 02's row sharding on one device.

Tolerances of the torch sampling backend (float32), as the JAX package
documents its own: the same polyline count and shapes as numpy, geometry
within rtol 1e-4 and atol 1e-3 of numpy float64; the kernel's order of
float32 operations within 1e-5 × the largest |coordinate| of its plain
version.
"""

from __future__ import annotations

import json
import pickle
import re
import subprocess
import sys
import tarfile
from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plotweave.frontends import gcode as J
from plotweave.frontends import svg as JS
from plotweave.stream import MotionProfile as JProfile
from plotweave_torch.frontends import gcode as G
from plotweave_torch.frontends import svg as S
from plotweave_torch.ops import bezier, kernels
from plotweave_torch.stream import MotionProfile
from plotweave_torch.stream.decoder import StreamDecoder, replay

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden" / "gcode"
E2E = REPO / "tests" / "golden" / "e2e"


# --- G-code → stream ------------------------------------------------------------


def test_gcode2stream_byte_equality_speed_scaled():
    text = (GOLDEN / "sample.gcode").read_text()
    data, _ = G.gcode_to_stream(text, invert_y=True, profile=MotionProfile(invert_y=True), speed_scale=1.3)
    assert data == (GOLDEN / "ref_g.bin").read_bytes()


def test_gcode2stream_byte_equality_no_reorder():
    text = (GOLDEN / "sample.gcode").read_text()
    data, _ = G.gcode_to_stream(text, reorder=False, profile=MotionProfile())
    assert data == (GOLDEN / "ref_g2.bin").read_bytes()


def test_gcode2stream_cli_matches_golden(tmp_path):
    from plotweave_torch.frontends.gcode2stream import main

    main([str(GOLDEN / "sample.gcode"), "-o", str(tmp_path / "g.bin"), "--invert-y", "1", "--speed-scale", "1.3",
          "--meta", str(tmp_path / "g.json")])
    assert (tmp_path / "g.bin").read_bytes() == (GOLDEN / "ref_g.bin").read_bytes()
    main([str(GOLDEN / "sample.gcode"), "-o", str(tmp_path / "g2.bin"), "--no-reorder"])
    assert (tmp_path / "g2.bin").read_bytes() == (GOLDEN / "ref_g2.bin").read_bytes()
    assert json.loads((tmp_path / "g.json").read_text())["bytes"] == len((GOLDEN / "ref_g.bin").read_bytes())


def test_gcode_parser_features():
    paths, moves = G.parse_polylines_mm((GOLDEN / "sample.gcode").read_text())
    assert len(paths) == 4 and moves == 4 + 3 + 2 + 1
    assert abs(paths[-1][0][0] - 177.8) < 1e-9  # inches converted: X7 → 177.8 mm


def _fuzz_gcode(rng, stateful: bool) -> str:
    lines = ["G90", "G21"] if rng.random() < 0.7 else []
    for _ in range(int(rng.integers(20, 120))):
        r = rng.random()
        if r < 0.08:
            lines.append(str(rng.choice(["; comment", "(note)", "G1 (mid) X3 Y4", "X1 (unclosed Y9", "G1 X2 ) Y3"])))
        elif r < 0.18:
            lines.append(str(rng.choice(["M3", "M4", "M5", "m3", "m5"])))
        elif r < 0.26:
            lines.append(f"G1 Z{rng.uniform(-2, 2):.2f}")
        elif r < 0.30:
            lines.append(str(rng.choice(["FOO", "G", "X", "Xabc Y2", "M X1"])))
        elif stateful and r < 0.40:
            lines.append(str(rng.choice(["G91", "G90", "G20", "G21", "G20 X1 G21 Y1", "G91 X5 G90 X10", "X-0 Y-0"])))
        else:
            parts = ["G1" if rng.random() < 0.5 else "g0"]
            if rng.random() < 0.9:
                parts.append(f"X{rng.uniform(-20, 220):.3f}")
            if rng.random() < 0.9:
                parts.append(f"Y{rng.uniform(-20, 300):.3f}")
            if rng.random() < 0.15:
                parts.append(f"X{rng.uniform(0, 50):.3f}")
            lines.append(" ".join(parts))
    return "\n".join(lines)


def _same_paths(a, b, text):
    assert len(a) == len(b), text
    for pa, pb in zip(a, b):
        fa, fb = np.asarray(pa, np.float64), np.asarray(pb, np.float64)
        assert fa.shape == fb.shape and np.array_equal(fa.view(np.uint64), fb.view(np.uint64)), text


@pytest.mark.parametrize("seed", [7, 13, 29, 31])
def test_fast_and_exact_parsers_match_each_other_and_jax(seed):
    """The port's vectorized parser == its exact state machine == the JAX
    package's parsers, bit for bit, on fuzz documents (G91 and G20 too)."""
    rng = np.random.default_rng(seed)
    for trial in range(20):
        text = _fuzz_gcode(rng, stateful=trial % 2 == 1)
        fast = G._parse_polylines_mm_fast(text)
        exact = G._parse_polylines_mm_py(text)
        assert fast is not None and fast[1] == exact[1], text
        _same_paths(fast[0], exact[0], text)
        ref = J._parse_polylines_mm_fast(text)
        assert ref[1] == fast[1], text
        _same_paths(fast[0], ref[0], text)


def test_parser_nonfinite_dispatch_and_line_separators():
    for text in ["; info: nanotool\nM3\nG1 X10 Y10\nM5", "INFO\nM3\nG1 X3 Y4", "Finf\nM3\nG1 X2 Y2"]:
        assert G._parse_polylines_mm_fast(text) is not None, text
    for text in ["M3\nG1 Xnan Y1", "M3\nG1 X1e999 Y1", "Znan\nG1 X1 Y1", "Ginf\nG1 X1 Y1", "M3\x00G1 X1 Y1"]:
        assert G._parse_polylines_mm_fast(text) is None, text
    with pytest.raises(OverflowError):
        G._parse_polylines_mm_py("Ginf\nG1 X1 Y1")
    base = ["M3", "G1 X10 Y10", "; comment", "G1 X20 Y5 (mid) Y7", "M5", "G1 X0 Y0"]
    for sep in ["\r", "\r\n", "\f", "\v", "\x85", " "]:
        text = sep.join(base)
        fast, exact = G._parse_polylines_mm_fast(text), G._parse_polylines_mm_py(text)
        assert fast[1] == exact[1] == 2 and len(fast[0]) == 1, repr(sep)
        _same_paths(fast[0], exact[0], repr(sep))
    with pytest.raises(ValueError):
        G.mm_polylines_to_steps([np.array([[0.0, 0.0], [np.nan, 5.0]])], 40.0, 1000, 1000, False)


def test_fast_parser_stream_bytes_match_exact_and_jax():
    text = _fuzz_gcode(np.random.default_rng(11), stateful=False)
    fast, _ = G.gcode_to_stream(text, invert_y=True, profile=MotionProfile(invert_y=True))
    steps = G.mm_polylines_to_steps(G._parse_polylines_mm_py(text)[0], 40.0, 8400, 11880, True)
    assert fast == G.emit_stream(G.order_nearest_l1(steps, (0, 0)), MotionProfile(invert_y=True), 3)
    assert fast == J.gcode_to_stream(text, invert_y=True, profile=JProfile(invert_y=True))[0]
    assert len(fast) % 1024 == 0


def test_native_tokenizer_matches_regex_and_order_l1():
    """The port's native library (its own build) behind the tokenizer and the
    L1 ordering, against the regex tokenizer and a numpy scan."""
    from plotweave_torch.native.api import order_l1_native

    assert G._tokenize_native("G1 X1") is not None, "the port's native library did not load"
    rng = np.random.default_rng(23)
    tokens = ["X1_0", "X1__0", "X.5", "X5.", "X+", "X1e5", "X1e", "X0x10", "Xabc", "X1.2.3", "G01", "m03", "z-0.0"]
    for _ in range(20):
        lines = [" ".join(str(rng.choice(tokens)) for _ in range(int(rng.integers(1, 5)))) if rng.random() < 0.3
                 else f"G1 X{rng.uniform(-9, 9):.4f}\tY{rng.uniform(-9, 9):.4f} ; c" for _ in range(30)]
        text = "\n".join(lines)
        nat, reg = G._tokenize_native(text), G._tokenize_regex(text)
        for i in range(5):
            np.testing.assert_array_equal(np.asarray(nat[i]), np.asarray(reg[i]))
        nv, rv = np.asarray(nat[5]), np.asarray(reg[5])
        assert ((nv == rv) | (np.isnan(nv) & np.isnan(rv))).all()
        np.testing.assert_array_equal(np.asarray(nat[6]), np.asarray(reg[6]))
    assert G._tokenize_native("G1 X1e999") is G._NEEDS_EXACT and G._tokenize_native("G1 X1\x1fY2") is None
    for _ in range(10):
        n = int(rng.integers(1, 60))
        starts, ends = (rng.integers(0, 7, (n, 2)).astype(np.int64) for _ in range(2))
        alive, cur, expect = list(range(n)), np.zeros(2, np.int64), []
        while alive:
            i = alive.pop(int(np.argmin(np.abs(starts[alive] - cur).sum(axis=1))))
            expect.append(i)
            cur = ends[i]
        assert order_l1_native(starts, ends, 0, 0).tolist() == expect


def test_polylines_to_gcode_matches_jax_and_numpy_fallback():
    import unittest.mock as mock

    rng = np.random.default_rng(17)
    polys = [rng.uniform(-300, 300, (int(rng.integers(1, 50)), 2)) for _ in range(40)]
    polys.append(rng.integers(-64000, 64000, (500, 2)) / np.float64(16.0))  # exact decimal ties
    doc = S.polylines_to_gcode(polys, 3)
    assert doc == JS.polylines_to_gcode(polys, 3)
    with mock.patch("plotweave_torch.native.api.gcode_text_native", return_value=None):
        assert S.polylines_to_gcode(polys, 3) == doc
    assert S.polylines_to_gcode([], 3) == "G21\nG90\nM5\n"


# --- SVG ------------------------------------------------------------------------


def test_svg_path_grammar_transforms_and_fit():
    tri = S.parse_path_data("M 0 0 L 10 0 L 10 10 Z")[0]
    assert (tri[0] == tri[-1]).all()
    q = S.parse_path_data("m 0 0 q 5 -5 10 0 t 10 0")[0]
    assert abs(q[-1][0] - 20) < 1e-9 and abs(q[-1][1]) < 1e-6
    assert np.allclose(S.parse_path_data("M 0 0 A 10 10 0 0 1 20 0")[0][-1], [20, 0], atol=1e-6)
    svg = ('<svg xmlns="http://www.w3.org/2000/svg"><g transform="translate(5,5) scale(2)">'
           '<rect x="0" y="0" width="10" height="10"/></g></svg>')
    polys = S.svg_to_polylines(svg)
    assert np.allclose(polys[0].min(axis=0), [5, 5]) and np.allclose(polys[0].max(axis=0), [25, 25])
    assert np.allclose(np.concatenate(S.fit_to_page(polys, 210, 297, 10)).min(axis=0), [10, 10])


def random_svg(seed: int, n_paths: int = 12, segments: int = 12, shapes: int = 6, size=(420, 297)) -> str:
    """A seeded document of paths mixing C S Q T A L H V Z and their relative
    forms, circles, ellipses and rects under transforms."""
    rng = np.random.default_rng(seed)
    w, h = size

    def xy(lo=0.0, hi=None):
        return f"{rng.uniform(lo, hi or w):.3f},{rng.uniform(lo, hi or h):.3f}"

    def rel():
        return f"{rng.uniform(-30, 30):.3f},{rng.uniform(-30, 30):.3f}"

    body = []
    for _ in range(n_paths):
        d = [f"M {xy()}"]
        for _ in range(segments):
            cmd = str(rng.choice(list("CSQTALcsqtalHVhv")))
            if cmd == "C":
                d.append(f"C {xy()} {xy()} {xy()}")
            elif cmd == "c":
                d.append(f"c {rel()} {rel()} {rel()}")
            elif cmd in "Ss":
                d.append(f"{cmd} {xy() if cmd == 'S' else rel()} {xy() if cmd == 'S' else rel()}")
            elif cmd in "Qq":
                d.append(f"{cmd} {xy() if cmd == 'Q' else rel()} {xy() if cmd == 'Q' else rel()}")
            elif cmd in "Tt":
                d.append(f"{cmd} {xy() if cmd == 'T' else rel()}")
            elif cmd in "Aa":
                d.append(f"{cmd} {rng.uniform(2, 40):.2f} {rng.uniform(2, 40):.2f} {rng.uniform(0, 90):.1f} "
                         f"{int(rng.integers(0, 2))} {int(rng.integers(0, 2))} {xy() if cmd == 'A' else rel()}")
            elif cmd in "Ll":
                d.append(f"{cmd} {xy() if cmd == 'L' else rel()}")
            else:
                d.append(f"{cmd} {rng.uniform(0, w if cmd in 'Hh' else h):.3f}")
        if rng.random() < 0.3:
            d.append("Z")
        body.append(f'<path d="{" ".join(d)}" transform="rotate({rng.uniform(-5, 5):.2f})"/>')
    for _ in range(shapes):
        body.append(f'<circle cx="{rng.uniform(0, w):.2f}" cy="{rng.uniform(0, h):.2f}" r="{rng.uniform(1, 30):.2f}"/>')
        body.append(f'<ellipse cx="{rng.uniform(0, w):.2f}" cy="{rng.uniform(0, h):.2f}" rx="{rng.uniform(1, 30):.2f}" '
                    f'ry="{rng.uniform(1, 20):.2f}"/>')
        body.append(f'<rect x="{rng.uniform(0, w):.2f}" y="{rng.uniform(0, h):.2f}" width="{rng.uniform(1, 50):.2f}" '
                    f'height="{rng.uniform(1, 50):.2f}"/>')
    return (f'<svg xmlns="http://www.w3.org/2000/svg" viewBox="0 0 {w} {h}"><g transform="translate(3,4)">'
            + "".join(body) + "</g></svg>")


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_numpy_backend_equals_jax_package(seed):
    """numpy float64 is the byte contract: polylines and G-code equal the JAX
    package's bit for bit."""
    from plotweave.frontends.svg2gcode import convert as jconvert
    from plotweave_torch.frontends.svg2gcode import convert

    svg = random_svg(seed)
    a, b = S.svg_to_polylines(svg), JS.svg_to_polylines(svg)
    assert len(a) == len(b)
    for pa, pb in zip(a, b):
        np.testing.assert_array_equal(pa, pb)
    for mode in ("bbox", "viewbox"):
        assert convert(svg, fit_mode=mode) == jconvert(svg, fit_mode=mode)


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_torch_backend_on_the_cpu_meets_the_tolerances(seed):
    """The plain K14 through ``BezierSampler("cpu")``: the polyline count and
    shapes of numpy and of the JAX package's ``xp=jax.numpy``, geometry within
    rtol 1e-4 / atol 1e-3 of numpy float64 and of the JAX float32 sampling;
    one sampling call per curve family of each path."""
    svg = random_svg(seed)
    sampler = bezier.BezierSampler("cpu")
    got = S.svg_to_polylines(svg, xp=sampler)
    ref = S.svg_to_polylines(svg)
    jx = JS.svg_to_polylines(svg, xp=jnp)
    assert len(got) == len(ref) == len(jx)
    for g, r, j in zip(got, ref, jx):
        assert g.shape == r.shape == j.shape
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(g, j, rtol=1e-4, atol=1e-3)
    families = sum(bool(re.search("[CcSs]", d)) + bool(re.search("[QqTt]", d))
                   for d in re.findall(r' d="([^"]*)"', svg))
    assert sampler.calls == families and sampler.seconds["sample"] > 0


@pytest.mark.parametrize("k", [3, 4])
@pytest.mark.parametrize("n", [1, 2, 8, 37, 128])
def test_plain_sampler_matches_numpy_float64(k, n):
    rng = np.random.default_rng(k * 1000 + n)
    ctrl = rng.uniform(-500, 4200, (50, k, 2))
    sample = S.sample_cubics_batched if k == 4 else S.sample_quads_batched
    ref = sample(ctrl, n)
    got = bezier.sample_bezier_plain(torch.from_numpy(ctrl.astype(np.float32)), n)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape == (50, n, 2)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-3)
    jref = np.asarray(JS.sample_cubics_batched(ctrl, n, xp=jnp) if k == 4 else JS.sample_quads_batched(ctrl, n, xp=jnp))
    np.testing.assert_allclose(got.numpy(), jref, rtol=1e-4, atol=1e-3)


def _k14_emulation(ctrl: np.ndarray, n: int) -> np.ndarray:
    """K14 thread by thread in numpy float32: t = i / (n − 1) rounded, the
    basis in the kernel's order, the sum over the control points from 0."""
    f = np.float32
    t = (np.arange(n, dtype=f) / f(max(n - 1, 1))).astype(f)
    u = f(1) - t
    if ctrl.shape[1] == 4:
        b = [u * u * u, f(3) * (u * u) * t, f(3) * u * (t * t), t * t * t]
    else:
        b = [u * u, f(2) * u * t, t * t]
    out = np.zeros((ctrl.shape[0], n, 2), f)
    for k, bk in enumerate(b):
        out = out + bk[None, :, None] * ctrl[:, k, None, :].astype(f)
    return out


@pytest.mark.parametrize("k", [3, 4])
def test_kernel_order_of_operations_within_tolerance_of_plain(k):
    rng = np.random.default_rng(k)
    ctrl = rng.uniform(-500, 4200, (300, k, 2)).astype(np.float32)
    for n in (1, 8, 100, 128):
        emu = _k14_emulation(ctrl, n)
        plain = bezier.sample_bezier_plain(torch.from_numpy(ctrl), n).numpy()
        assert np.abs(emu - plain).max() <= 1e-5 * np.abs(ctrl).max()


def test_sampler_device_policy_and_wrapper(monkeypatch):
    """The torch backend samples on the card unless asked for the CPU, and
    never falls back: without a card "auto" raises; K14's wrapper refuses a
    CPU tensor."""
    with pytest.raises(ValueError, match="CUDA"):
        kernels.bezier_sample_cuda(torch.zeros(2, 4, 2), 8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--sampling-device cpu"):
        bezier.BezierSampler("auto")
    from plotweave_torch.frontends.svg2gcode import convert

    with pytest.raises(RuntimeError, match="CUDA"):
        convert(random_svg(5), sampling_backend="torch")
    assert bezier.BezierSampler("cpu").device == torch.device("cpu")


def test_svg_to_stream_chain():
    from plotweave_torch.frontends.svg2gcode import convert

    svg = ('<svg xmlns="http://www.w3.org/2000/svg" viewBox="0 0 100 100">'
           '<circle cx="50" cy="50" r="30"/><path d="M10,10 C 30,0 70,0 90,10"/></svg>')
    data, info = G.gcode_to_stream(convert(svg), invert_y=True)
    dec = StreamDecoder(data)
    res = replay(dec, *info["canvas_steps"])
    assert dec.stats.eof_seen and dec.stats.off_canvas_steps == 0
    assert len(res.polylines) == info["polylines_steps"] == 2


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_svg2stream_orchestrator_matches_jax_package(tmp_path, backend):
    """The port's orchestrator (G-code out, preview) against the JAX
    package's on the same document: numpy byte for byte; the torch backend
    on the CPU with the same path count, decoding to EOF on the canvas."""
    from plotweave.frontends.svg2stream import main as jmain
    from plotweave_torch.frontends.svg2stream import main

    src = tmp_path / "in.svg"
    src.write_text(random_svg(7))
    extra = ["--sampling-backend", "torch", "--sampling-device", "cpu"] if backend == "torch" else []
    main([str(src), "-o", str(tmp_path / "p.bin"), "--gcode-out", str(tmp_path / "p.gcode"),
          "--preview", str(tmp_path / "p.png"), *extra])
    jmain([str(src), "-o", str(tmp_path / "j.bin"), "--gcode-out", str(tmp_path / "j.gcode")])
    data = (tmp_path / "p.bin").read_bytes()
    ref = (tmp_path / "j.bin").read_bytes()
    pg, jg = (tmp_path / "p.gcode").read_text(), (tmp_path / "j.gcode").read_text()
    if backend == "numpy":
        assert data == ref and pg == jg
        assert (tmp_path / "p.json").read_text() == (tmp_path / "j.json").read_text()
    assert pg.count("M3") == jg.count("M3") > 0
    meta = json.loads((tmp_path / "p.json").read_text())
    assert meta["canvas_steps"] == [8400, 11880]
    dec = StreamDecoder(data)
    replay(dec, 8400, 11880)
    assert dec.stats.eof_seen and dec.stats.off_canvas_steps == 0
    assert cv2.imread(str(tmp_path / "p.png")) is not None


def test_svg2gcode_cli_backends(tmp_path, capsys):
    from plotweave_torch.frontends.svg2gcode import main

    src = tmp_path / "in.svg"
    src.write_text(random_svg(9))
    main([str(src), "-o", str(tmp_path / "a.gcode")])
    main([str(src), "-o", str(tmp_path / "b.gcode"), "--sampling-backend", "torch", "--sampling-device", "cpu"])
    a, b = (tmp_path / "a.gcode").read_text(), (tmp_path / "b.gcode").read_text()
    assert a.count("M3") == b.count("M3") > 0 and len(a.splitlines()) == len(b.splitlines())
    (tmp_path / "bad.svg").write_text("<svg")
    with pytest.raises(SystemExit) as e:
        main([str(tmp_path / "bad.svg")])
    assert e.value.code == 2 and "not valid SVG" in capsys.readouterr().err


@pytest.mark.parametrize("module,args", [
    ("svg2stream", ["{svg}", "-o", "{out}/s.bin", "--sampling-backend", "torch", "--sampling-device", "cpu"]),
    ("gcode2stream", ["{gcode}", "-o", "{out}/g2.bin", "--no-reorder"]),
])
def test_modules_run_with_python_m(tmp_path, module, args):
    svg = tmp_path / "in.svg"
    svg.write_text(random_svg(4, n_paths=3, shapes=2))
    argv = [a.format(svg=svg, gcode=GOLDEN / "sample.gcode", out=tmp_path) for a in args]
    run = subprocess.run([sys.executable, "-m", f"plotweave_torch.frontends.{module}", *argv], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    assert "Stream saved" in run.stdout
    if module == "gcode2stream":
        assert (tmp_path / "g2.bin").read_bytes() == (GOLDEN / "ref_g2.bin").read_bytes()


# --- gcode2svg, the demo, the manifest creator, analysis -----------------------------

GCODE = """G21
G90
M5
G0 X10.0 Y20.0
M3
G1 X40.5 Y20.0
G1 X40.5 Y55.25
M5
G0 X60 Y60
M3
G1 X61.2 Y80.4
G1 X10 Y80.4
M5
"""


def test_gcode2svg_matches_jax_package(tmp_path):
    from plotweave.frontends.gcode2svg import gcode_to_svg as jsvg
    from plotweave_torch.frontends.gcode2svg import gcode_to_svg, main

    (tmp_path / "in.gcode").write_text(GCODE)
    main([str(tmp_path / "in.gcode"), "-o", str(tmp_path / "out.svg")])
    assert (tmp_path / "out.svg").read_text() == jsvg(GCODE)
    fuzz = _fuzz_gcode(np.random.default_rng(3), stateful=True)
    assert gcode_to_svg(fuzz, scale=2.5, stroke="red") == jsvg(fuzz, scale=2.5, stroke="red")
    empty = gcode_to_svg("G21\nG90\nM5\n")
    assert "<svg" in empty and "polyline" not in empty


def test_demo_generator_matches_jax_package(tmp_path):
    from plotweave.demo.generator import generate_demo as jdemo
    from plotweave_torch.demo.generator import generate_demo

    data = generate_demo(str(tmp_path / "demo.bin"))
    assert data == jdemo(str(tmp_path / "jdemo.bin"))
    dec = StreamDecoder(data)
    res = replay(dec, 8400, 11880)
    assert dec.stats.eof_seen and dec.stats.taps == 63 and dec.stats.off_canvas_steps == 0
    assert len(res.polylines) > 100
    assert json.loads((tmp_path / "demo.json").read_text())["bytes"] == len(data)


def _manifest_tools():
    import importlib

    tools = str(REPO / "tests" / "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    return importlib.import_module("gen_manifest_creator_golden")


def test_manifest_creator_byte_equality_vs_reference_golden(tmp_path):
    from plotweave_torch.stream.manifest_creator import build

    gen = _manifest_tools()
    mp = gen.make_fixture(tmp_path / "vec")
    data = build(mp, tmp_path / "out.bin", gen.W_STEPS, gen.H_STEPS, MotionProfile())
    assert data == (REPO / "tests" / "golden" / "manifest_creator_ref.bin").read_bytes()


def test_manifest_creator_sorts_layers_and_matches_jax(tmp_path):
    from plotweave.stream.manifest_creator import build as jbuild
    from plotweave_torch.stream.manifest_creator import build, main

    for i, name in enumerate(["a", "b"]):
        (tmp_path / f"layer_{name}.pkl").write_bytes(pickle.dumps({
            "color_name": name, "color_idx": 1 - i,
            "contours": [{"points": np.array([[100, 100], [500, 400]], np.int32)}],
            "taps": [{"x": 600 + i, "y": 700}]}))
    (tmp_path / "manifest.json").write_text(json.dumps({"image_size": [8400, 11880], "layers": [
        {"file": f"layer_{n}.pkl", "color_name": n, "color_index": i} for i, n in enumerate(["a", "b"])]}))
    data = build(tmp_path / "manifest.json", tmp_path / "s.bin", 8400, 11880, MotionProfile())
    assert data == jbuild(tmp_path / "manifest.json", tmp_path / "j.bin", 8400, 11880, JProfile())
    dec = StreamDecoder(data)
    assert replay(dec, 8400, 11880).colors == [0, 1] and data[1] == 0x40 | 28 and dec.stats.taps == 2
    main([str(tmp_path / "manifest.json"), "-o", str(tmp_path / "cli.bin")])
    assert (tmp_path / "cli.bin").exists()


def test_utils_analysis_matches_jax_package(tmp_path, capsys):
    """A small run of the port's pipeline (CPU), then the port's stage table,
    combined SVG and layer composite against the JAX package's on the same
    run directory."""
    from plotweave.utils import analysis as janalysis
    from plotweave_torch.config import load_config
    from plotweave_torch.pipeline import run_pipeline
    from plotweave_torch.utils import analysis

    img = np.full((80, 100, 3), 255, np.uint8)
    cv2.circle(img, (30, 40), 18, (20, 20, 20), -1)
    cv2.rectangle(img, (55, 15), (90, 60), (40, 60, 200), -1)
    cv2.imwrite(str(tmp_path / "img.png"), img)
    out = tmp_path / "out"
    out.mkdir()
    cfg_d = {"input_image": str(tmp_path / "img.png"), "output_dir": str(out), "raster_device": "cpu",
             "colors": [[20, 20, 20], [40, 60, 200], [140, 180, 220], [235, 230, 225]],
             "color_names": ["layer_dark", "layer_mid", "layer_skin", "layer_light"],
             "target_width_mm": 100, "target_height_mm": 120, "pixels_per_mm": 3, "pen_width_px": 8}
    (out / "config.json").write_text(json.dumps(cfg_d))
    cfg = load_config(str(out / "config.json"))
    run_pipeline(cfg, 1, 13)
    from plotweave.config import load_config as jload

    jcfg = jload(str(out / "config.json"))
    stats = analysis.stage_stats(cfg)
    assert stats == janalysis.stage_stats(jcfg) and set(stats) == set(cfg_d["color_names"])
    analysis.export_combined_svg(cfg, str(tmp_path / "a.svg"))
    janalysis.export_combined_svg(jcfg, str(tmp_path / "j.svg"))
    assert (tmp_path / "a.svg").read_text() == (tmp_path / "j.svg").read_text()
    np.testing.assert_array_equal(analysis.combine_layers_to_image(cfg), janalysis.combine_layers_to_image(jcfg))
    capsys.readouterr()
    analysis.print_stage_table(cfg)
    mine = capsys.readouterr().out
    janalysis.print_stage_table(jcfg)
    assert mine == capsys.readouterr().out and "layer_dark" in mine
    analysis.main([str(out), "--svg", str(tmp_path / "cli.svg")])
    assert (tmp_path / "cli.svg").read_text() == (tmp_path / "a.svg").read_text()


# --- row sharding on one device ---------------------------------------------------


@pytest.mark.parametrize("h,req,ndev,radius", [(1500, 4, 1, 2), (1500, 4, 4, 2), (1500, 7, 8, 2), (13, 4, 4, 2),
                                               (100, 8, 8, 30), (97, 4, 4, 2), (1, 2, 2, 0), (64, 0, 4, 2)])
def test_fit_shard_rows_is_the_jax_packages(h, req, ndev, radius):
    from plotweave.parallel.spatial import fit_shard_rows as jfit
    from plotweave_torch.parallel.spatial import fit_shard_rows

    assert fit_shard_rows(h, req, ndev, radius) == jfit(h, req, ndev, radius)


@pytest.fixture(scope="module")
def golden_stream(tmp_path_factory):
    base = tmp_path_factory.mktemp("golden")
    with tarfile.open(E2E / "ref_artifacts.tar.gz") as tf:
        tf.extractall(base, filter="data")
    return (base / "plot_stream.bin").read_bytes()


def _run_base(out: Path, **extra):
    from plotweave_torch.config import load_config
    from plotweave_torch.pipeline import run_pipeline

    cfg = json.loads((E2E / "base_cfg.json").read_text())
    cfg.update(input_image=str(E2E / "testimg.png"), output_dir=str(out), **extra)
    out.mkdir(parents=True)
    (out / "config.json").write_text(json.dumps(cfg))
    run_pipeline(load_config(str(out / "config.json")), 1, 13)
    return (out / "plot_stream.bin").read_bytes()


def _cpu_pool(monkeypatch, n: int) -> None:
    """The CPU pool of both packages: ``--xla_force_host_platform_device_count``."""
    monkeypatch.setenv("XLA_FLAGS", f"--xla_force_host_platform_device_count={n}")


@pytest.mark.parametrize("override,note,cpus", [
    pytest.param({"shard_rows": 1}, "row-sharded over 1 device(s)", 1, id="override0-row-sharded over 1 device(s)"),
    pytest.param({"shard_rows": 4}, "row-sharded over 1 device(s)", 1, id="override1-row-sharded over 1 device(s)"),
    pytest.param({"shard_auto_mpx": 0.01}, None, 1, id="override2-note2"),
    pytest.param({"shard_rows": 4, "kmeans_init": "device"}, "[shard] note: row sharding applies to the fused host-exact",
                 1, id="override3-[shard] note: row sharding applies to the fused host-exact"),
    pytest.param({"shard_rows": 4}, "[shard] raster chain row-sharded over 4 device(s)", 4, id="4-cpus-shard-rows"),
    pytest.param({"shard_auto_mpx": 0.01}, "[shard] raster chain row-sharded over 4 device(s)", 4, id="4-cpus-auto"),
])
def test_row_sharding_on_one_device_equals_the_unsharded_run(tmp_path, capsys, monkeypatch, golden_stream, override,
                                                             note, cpus):
    """``shard_rows`` / ``shard_auto_mpx`` on the CPU shard over the CPU pool
    that ``XLA_FLAGS`` sets, as the JAX package does.  A pool of one runs the
    unsharded chain, byte-equal to the JAX package's 1-device sharded program
    and so to the golden stream, and auto never engages; a pool of four runs
    the row-sharded chain over four shards and prints the JAX package's
    line, byte-equal all the same.  The device mode prints the JAX package's
    note and runs unsharded."""
    _cpu_pool(monkeypatch, cpus)
    data = _run_base(tmp_path / "run", raster_device="cpu", **override)
    if "kmeans_init" not in override:
        assert data == golden_stream
    out = capsys.readouterr().out
    if note:
        assert note in out
    else:
        assert "[shard]" not in out  # auto never engages below two devices


def test_row_sharding_over_several_cards_raises(tmp_path, monkeypatch, golden_stream):
    """More than one card shards the chain over a ``space`` mesh of the
    cards, each once (mocked: four cards, ``shard_rows`` 2 takes two), whose
    route launches the slab kernels' wrappers (K2 and K3+K4 once a shard, K5
    and K6 once a shard a round) and no plain op: the stream is the golden
    one.  One card resolves to the unsharded chain.  On the CPU the count
    is the CPU pool's: one, or the four that ``XLA_FLAGS`` sets."""
    from mocked_cards import launches, stage02_on_cards
    from plotweave_torch.config import PipelineConfig
    from plotweave_torch.ops.kernels import STATS
    from plotweave_torch.stages import s02_color_extract as s02

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cfg = PipelineConfig(shard_rows=4)
    assert s02.resolve_shard_n(cfg, 1500, 2000) == 4
    _cpu_pool(monkeypatch, 1)
    assert s02.resolve_shard_n(PipelineConfig(shard_rows=4, raster_device="cpu"), 1500, 2000) == 1
    _cpu_pool(monkeypatch, 4)
    assert s02.resolve_shard_n(PipelineConfig(shard_rows=4, raster_device="cpu"), 1500, 2000) == 4
    assert s02.resolve_shard_n(PipelineConfig(shard_auto_mpx=1.0), 1500, 2000) == 4
    assert s02.resolve_shard_n(PipelineConfig(shard_auto_mpx=5.0), 1500, 2000) == 0
    calls, meshes = stage02_on_cards(monkeypatch, 4)
    assert _run_base(tmp_path / "run", shard_rows=2) == golden_stream
    assert meshes == [[torch.device("cuda", 0), torch.device("cuda", 1)]]
    assert launches(calls) == {
        "morph_steps_cuda": 2, "edge_candidates_slab_cuda": 2, "hysteresis_slab_cuda": 2 * STATS["hysteresis_rounds"],
        "zhang_suen_slab_cuda": 2 * STATS["thinning_rounds"]}
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert s02.resolve_shard_n(cfg, 1500, 2000) == 1
    assert s02.resolve_shard_n(PipelineConfig(shard_auto_mpx=1.0), 1500, 2000) == 0


def test_cli_has_shard_rows(tmp_path, golden_stream):
    from plotweave_torch.pipeline import main, parse_args

    assert parse_args(["img.png", "--shard-rows", "4"]).shard_rows == 4
    out = tmp_path / "cli"
    cfg = json.loads((E2E / "base_cfg.json").read_text())
    cfg.update(input_image=str(E2E / "testimg.png"), output_dir=str(out))
    out.mkdir()
    (out / "config.json").write_text(json.dumps(cfg))
    main([str(E2E / "testimg.png"), "--output", str(out), "--config", str(out / "config.json"),
          "--raster-device", "cpu", "--shard-rows", "4"])
    assert json.loads((out / "config.json").read_text())["shard_rows"] == 4
    assert (out / "plot_stream.bin").read_bytes() == golden_stream
