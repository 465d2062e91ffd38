"""The native pool's own JPEG and PNG decoders
(``znicz_tpu_torch/native/jpeg_decode.cpp``, ``png_decode.cpp``) against
the reference's pool (``znicz_tpu.native.ImagePipeline``, which links
libjpeg-turbo and libpng), on the CPU.  Every file is decoded by both
pools at its own size (no resize, the crop the whole image, raw uint8),
one file a submit, and the two give the same ``failed`` count.

- JPEG, bit-equal: 4:2:0, 4:2:2, 4:4:4, 4:4:0 and 4:1:1 sampling,
  progressive, grayscale, qualities 50/90/100, optimized Huffman tables,
  restart markers, at 1x1, 7x9, 17x33 and 500x375; a file without
  Huffman tables (the standard ones apply);
- PNG, bit-equal: gray, RGB and palette at every bit depth, plain and
  Adam7, 16-bit included, and tRNS keys and palettes;
- PNG with an alpha channel (LA, RGBA, 8- and 16-bit): within one level,
  the one place the decoder evaluates the sRGB curve where libpng reads
  a piecewise-linear table;
- damaged files: truncated JPEGs (libjpeg's filler, not a failure),
  truncated PNGs and bad CRCs (failures, or a dropped ancillary chunk),
  CMYK JPEGs (refused), all as the reference pool handles them; a PNG
  header far larger than its data fails holding no more memory than
  the RGB output;
- arithmetic-coded JPEGs: libjpeg decodes them, this decoder refuses
  them (ROADMAP C22);
- the library links zlib and no image library, and its name follows
  every source it is built from;
- C23: ``FileImageLoader`` in a graphed region (a stand-in for the CUDA
  graph API) captures and replays, its batch delivered in place.

JPEG variants Pillow does not write (4:4:0, 4:1:1, arithmetic coding,
CMYK) come from a small writer compiled here against the system's
libjpeg, the one the reference's pool links.
"""

import contextlib
import io
import os
import shutil
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image as PILImage

from znicz_tpu.native import ImagePipeline as RefPipeline
from znicz_tpu_torch import native
from znicz_tpu_torch.accelerated_units import JitRegion
from znicz_tpu_torch.loader.base import TRAIN
from znicz_tpu_torch.models.samples import imagenet
from znicz_tpu_torch.native import ImagePipeline
from znicz_tpu_torch.utils import prng
from znicz_tpu_torch.utils.config import reset_root

SIZES = ((1, 1), (9, 7), (33, 17), (375, 500))  # (h, w): 1x1 ... 500x375

JPEG_WRITER = r"""
#include <stdio.h>
#include <stdlib.h>
#include <jpeglib.h>
/* jpeg_writer OUT RAW W H NCOMP QUALITY "h0,v0,h1,v1,..." ARITH PROGRESSIVE */
int main(int argc, char **argv) {
  if (argc != 10) return 2;
  int w = atoi(argv[3]), h = atoi(argv[4]), nc = atoi(argv[5]);
  size_t n = (size_t)w * h * nc;
  unsigned char *px = malloc(n);
  FILE *in = fopen(argv[2], "rb");
  if (!in || fread(px, 1, n, in) != n) return 3;
  fclose(in);
  struct jpeg_compress_struct c;
  struct jpeg_error_mgr e;
  c.err = jpeg_std_error(&e);
  jpeg_create_compress(&c);
  FILE *out = fopen(argv[1], "wb");
  jpeg_stdio_dest(&c, out);
  c.image_width = w;
  c.image_height = h;
  c.input_components = nc;
  c.in_color_space = nc == 1 ? JCS_GRAYSCALE : (nc == 3 ? JCS_RGB : JCS_CMYK);
  jpeg_set_defaults(&c);
  jpeg_set_quality(&c, atoi(argv[6]), TRUE);
  char *s = argv[7];
  for (int i = 0; i < nc && *s; ++i) {
    c.comp_info[i].h_samp_factor = (int)strtol(s, &s, 10);
    if (*s == ',') ++s;
    c.comp_info[i].v_samp_factor = (int)strtol(s, &s, 10);
    if (*s == ',') ++s;
  }
  c.arith_code = atoi(argv[8]);
  if (atoi(argv[9])) jpeg_simple_progression(&c);
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW row = px + (size_t)c.next_scanline * w * nc;
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  fclose(out);
  return 0;
}
"""


@pytest.fixture(scope="module")
def jpeg_writer(tmp_path_factory):
    """``write(path, img, quality, sampling, arith, progressive)`` through
    the system's libjpeg."""
    d = tmp_path_factory.mktemp("jpeg_writer")
    (d / "jpeg_writer.c").write_text(JPEG_WRITER)
    exe = d / "jpeg_writer"
    subprocess.run(["gcc", "-O1", str(d / "jpeg_writer.c"), "-o", str(exe),
                    "-ljpeg"], check=True, capture_output=True)

    def write(path, img, quality=90, sampling="2,2,1,1,1,1", arith=0,
              progressive=0):
        h, w = img.shape[:2]
        nc = 1 if img.ndim == 2 else img.shape[2]
        raw = f"{path}.raw"
        np.ascontiguousarray(img, np.uint8).tofile(raw)
        subprocess.run([str(exe), str(path), raw, str(w), str(h), str(nc),
                        str(quality), sampling, str(arith),
                        str(progressive)], check=True, capture_output=True)
        return Path(path).read_bytes()
    return write


def texture(rng, h, w, channels=3) -> np.ndarray:
    """A textured frame (waves and noise), not white noise, so the
    entropy coder sees runs and the upsampler smooth chroma."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    planes = [128 + 90 * np.sin(x / rng.uniform(3, 30) + c)
              * np.cos(y / rng.uniform(3, 30) - c) for c in range(channels)]
    arr = np.stack(planes, -1) + rng.normal(0, 12, (h, w, channels))
    arr = np.clip(arr, 0, 255).astype(np.uint8)
    return arr[..., 0] if channels == 1 else arr


def decode(cls, path, hw):
    """One file through a pool at its own size: ``(pixels, failed)``."""
    pipe = cls(2)
    try:
        out = np.full((1, *hw, 3), 7, np.uint8)
        pipe.submit([str(path)], out, out_hw=hw)
        failed = pipe.wait()
    finally:
        pipe.close()
    return out[0], failed


def assert_same(path, hw, tol=0):
    """Both pools on ``path``: the same failed count and pixels equal
    (or within ``tol`` levels)."""
    got, got_failed = decode(ImagePipeline, path, hw)
    want, want_failed = decode(RefPipeline, path, hw)
    assert got_failed == want_failed, (path, got_failed, want_failed)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= tol, (path, int(diff.max()), int((diff > 0).sum()))
    return got_failed, diff


def pillow_jpeg(img, **kwargs) -> bytes:
    buf = io.BytesIO()
    PILImage.fromarray(img).save(buf, "JPEG", **kwargs)
    return buf.getvalue()


# ------------------------------------------------------------------- JPEG
#: variant -> (writer, arguments): "pil" for Pillow's save, "lib" for
#: the libjpeg writer
JPEG_VARIANTS = {
    "420": ("pil", dict(quality=90, subsampling=2)),
    "422": ("pil", dict(quality=90, subsampling=1)),
    "444": ("pil", dict(quality=90, subsampling=0)),
    "440": ("lib", dict(sampling="1,2,1,1,1,1")),
    "411": ("lib", dict(sampling="4,1,1,1,1,1")),
    "progressive": ("pil", dict(quality=90, progressive=True)),
    "progressive_444": ("pil", dict(quality=90, subsampling=0,
                                    progressive=True)),
    "progressive_440": ("lib", dict(sampling="1,2,1,1,1,1", progressive=1)),
    "gray": ("pil", dict(quality=90)),
    "gray_progressive": ("pil", dict(quality=90, progressive=True)),
    "quality50": ("pil", dict(quality=50)),
    "quality100": ("pil", dict(quality=100)),
    "optimized": ("pil", dict(quality=90, optimize=True)),
    "restart_markers": ("pil", dict(quality=90, restart_marker_blocks=2)),
    "restart_progressive": ("pil", dict(quality=75, progressive=True,
                                        restart_marker_blocks=3)),
}


@pytest.mark.parametrize("variant", sorted(JPEG_VARIANTS))
def test_jpeg_equals_the_reference_pool(tmp_path, jpeg_writer, variant):
    kind, kwargs = JPEG_VARIANTS[variant]
    rng = np.random.default_rng(sorted(JPEG_VARIANTS).index(variant))
    channels = 1 if variant.startswith("gray") else 3
    for h, w in SIZES:
        img = texture(rng, h, w, channels)
        path = tmp_path / f"{variant}_{h}x{w}.jpg"
        if kind == "pil":
            path.write_bytes(pillow_jpeg(img, **kwargs))
        else:
            jpeg_writer(path, img, **kwargs)
        failed, _ = assert_same(path, (h, w))
        assert failed == 0


def strip_huffman_tables(data: bytes) -> bytes:
    """The file without its DHT segments (a Motion-JPEG frame)."""
    out, i = bytearray(data[:2]), 2
    while i < len(data):
        marker = data[i + 1]
        if marker == 0xDA:  # the scan and everything after it
            out += data[i:]
            break
        length = struct.unpack(">H", data[i + 2:i + 4])[0]
        if marker != 0xC4:
            out += data[i:i + 2 + length]
        i += 2 + length
    return bytes(out)


def test_jpeg_without_huffman_tables_takes_the_standard_ones(tmp_path):
    rng = np.random.default_rng(40)
    img = texture(rng, 48, 61)
    data = strip_huffman_tables(pillow_jpeg(img, quality=85))
    assert b"\xff\xc4" not in data[:data.index(b"\xff\xda")]
    path = tmp_path / "mjpeg.jpg"
    path.write_bytes(data)
    failed, _ = assert_same(path, (48, 61))
    assert failed == 0


# -------------------------------------------------------------------- PNG
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def png_chunk(kind: bytes, data: bytes, bad_crc: bool = False) -> bytes:
    crc = zlib.crc32(kind + data) ^ int(bad_crc)
    return struct.pack(">I", len(data)) + kind + data + \
        struct.pack(">I", crc & 0xffffffff)


def pack_row(samples: np.ndarray, depth: int) -> bytes:
    if depth == 16:
        return samples.astype(">u2").tobytes()
    if depth == 8:
        return samples.astype(np.uint8).tobytes()
    per = 8 // depth
    padded = np.concatenate([samples, np.zeros((-len(samples)) % per,
                                               samples.dtype)])
    groups = padded.reshape(-1, per).astype(np.uint32)
    packed = np.zeros(len(groups), np.uint32)
    for k in range(per):
        packed |= groups[:, k] << (8 - depth * (k + 1))
    return packed.astype(np.uint8).tobytes()


def filtered(rows: list[bytes], bpp: int) -> bytes:
    """Each row under filter ``row index % 5`` (all five in turn)."""
    out, prev = bytearray(), bytes(len(rows[0]) if rows else 0)
    for y, row in enumerate(rows):
        f = y % 5
        line = bytearray(len(row))
        for i, v in enumerate(row):
            a = row[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            if f == 0:
                p = 0
            elif f == 1:
                p = a
            elif f == 2:
                p = b
            elif f == 3:
                p = (a + b) >> 1
            else:
                pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                p = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            line[i] = (v - p) & 255
        out.append(f)
        out += line
        prev = row
    return bytes(out)


def make_png(samples, ctype, depth, interlace=0, palette=None, trns=None,
             gamma=None, bad_crc=None, n_idat=1) -> bytes:
    """A PNG of ``samples`` ((h, w) or (h, w, channels) integers) written
    here, every filter type used."""
    h, w = samples.shape[:2]
    ch = CHANNELS[ctype]
    samples = samples.reshape(h, w, ch)
    bpp = max(1, ch * depth // 8)
    raw = b""
    for sx, sy, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[sy::dy, sx::dx]
        if sub.size:
            raw += filtered([pack_row(r.reshape(-1), depth) for r in sub],
                            bpp)
    z = zlib.compress(raw, 6)
    out = b"\x89PNG\r\n\x1a\n" + png_chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                             interlace), bad_crc == "IHDR")
    if gamma is not None:
        out += png_chunk(b"gAMA", struct.pack(">I", gamma))
    if palette is not None:
        out += png_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += png_chunk(b"tRNS", trns, bad_crc == "tRNS")
    for i in range(n_idat):
        part = z[i * len(z) // n_idat:(i + 1) * len(z) // n_idat]
        out += png_chunk(b"IDAT", part, bad_crc == "IDAT" and i == n_idat - 1)
    return out + png_chunk(b"IEND", b"")


def png_case(rng, kind, depth, h, w):
    """``(samples, ctype, palette)`` of a kind: gray, rgb or palette."""
    top = (1 << depth) - 1
    if kind == "gray":
        return rng.integers(0, top + 1, (h, w)), 0, None
    if kind == "rgb":
        return rng.integers(0, top + 1, (h, w, 3)), 2, None
    n = int(rng.integers(1, top + 2))
    return (rng.integers(0, n, (h, w)), 3,
            rng.integers(0, 256, (n, 3)))


PNG_OPAQUE = [(kind, depth, interlace)
              for kind, depths in (("gray", (1, 2, 4, 8, 16)),
                                   ("rgb", (8, 16)),
                                   ("palette", (1, 2, 4, 8)))
              for depth in depths for interlace in (0, 1)]


@pytest.mark.parametrize("kind,depth,interlace", PNG_OPAQUE)
def test_png_equals_the_reference_pool(tmp_path, kind, depth, interlace):
    """Bit-equal, 16-bit samples included (gamma-encoded to sRGB as
    libpng does, and libpng's row buffer showing through the even rows
    of an interlaced 16-bit image)."""
    rng = np.random.default_rng(depth * 10 + interlace)
    for h, w in SIZES[:3] + ((40, 37),):
        samples, ctype, palette = png_case(rng, kind, depth, h, w)
        path = tmp_path / f"{kind}{depth}_{interlace}_{h}x{w}.png"
        path.write_bytes(make_png(samples, ctype, depth, interlace,
                                  palette=palette))
        failed, _ = assert_same(path, (h, w))
        assert failed == 0


def test_png_gamma_chunk_is_honoured(tmp_path):
    rng = np.random.default_rng(5)
    cases = [(rng.integers(0, 256, (20, 21, 3)), 2, 8, 100000),
             (rng.integers(0, 256, (20, 21)), 0, 8, 50000),
             (rng.integers(0, 65536, (20, 21)), 0, 16, 45455)]
    for i, (samples, ctype, depth, gamma) in enumerate(cases):
        path = tmp_path / f"gamma{i}.png"
        path.write_bytes(make_png(samples, ctype, depth, gamma=gamma))
        failed, _ = assert_same(path, (20, 21))
        assert failed == 0


def test_png_transparency_keys_and_palettes(tmp_path):
    """tRNS on gray, RGB and palette images, bit-equal: keyed pixels
    composite to black, palette entries in libpng's linear light."""
    rng = np.random.default_rng(6)
    gray = rng.integers(0, 256, (30, 31))
    gray[::3] = 77
    rgb = rng.integers(0, 4, (30, 31, 3)) * 60
    gray16 = rng.integers(0, 4, (30, 31)) * 20000
    idx = np.arange(32 * 32).reshape(32, 32) % 256
    palette = rng.integers(0, 256, (256, 3))
    alphas = rng.permutation(256).astype(np.uint8).tobytes()
    cases = [
        (gray, 0, 8, None, struct.pack(">H", 77)),
        (rgb, 2, 8, None, struct.pack(">HHH", 60, 0, 120)),
        (rng.integers(0, 4, (30, 31)), 0, 2, None, struct.pack(">H", 1)),
        (gray16, 0, 16, None, struct.pack(">H", 20000)),
        (idx, 3, 8, palette, alphas),
        (idx, 3, 8, palette, alphas[:100]),
    ]
    for i, (samples, ctype, depth, pal, trns) in enumerate(cases):
        h, w = samples.shape[:2]
        for interlace in (0, 1):
            path = tmp_path / f"trns{i}_{interlace}.png"
            path.write_bytes(make_png(samples, ctype, depth, interlace,
                                      palette=pal, trns=trns))
            failed, _ = assert_same(path, (h, w))
            assert failed == 0


@pytest.mark.parametrize("ctype,depth", [(4, 8), (6, 8), (4, 16), (6, 16)])
def test_png_alpha_within_one_level(tmp_path, ctype, depth):
    """Every (value, alpha) pair at 8 bits, a ramp of all 65,536 values
    under varied alphas at 16: within one level of the reference (the
    tolerance: libpng encodes a partly transparent pixel's linear value
    through a piecewise-linear sRGB table; this decoder evaluates the
    curve, which the table misses by one level at 2 of its 256 inputs),
    and equal on most pixels."""
    if depth == 8:
        v, a = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    else:
        rng = np.random.default_rng(7)
        v = np.arange(65536).reshape(256, 256)
        a = rng.integers(0, 65536, (256, 256))
        a[:8], a[8:16] = 65535, 0
        a[16:24] = rng.integers(65400, 65536, (8, 256))
    samples = np.stack([v, a] if ctype == 4 else [v, v.T, v[::-1], a], -1)
    for interlace in (0, 1):
        path = tmp_path / f"alpha{ctype}_{depth}_{interlace}.png"
        path.write_bytes(make_png(samples, ctype, depth, interlace))
        failed, diff = assert_same(path, (256, 256), tol=1)
        assert failed == 0
        assert (diff > 0).mean() < 0.01


# --------------------------------------------------------- damaged files
def damaged_files(jpeg_writer, tmp_path):
    """``{name: (path, (h, w))}``."""
    rng = np.random.default_rng(8)
    files = {}
    for name, kwargs in (("baseline", dict(quality=90)),
                         ("restart", dict(quality=90,
                                          restart_marker_blocks=1)),
                         ("progressive", dict(quality=90,
                                              progressive=True))):
        img = texture(rng, 375, 500)
        data = pillow_jpeg(img, **kwargs)
        for frac in (0.5, 0.9):
            path = tmp_path / f"{name}_cut{int(frac * 100)}.jpg"
            path.write_bytes(data[:int(len(data) * frac)])
            files[path.stem] = (path, (375, 500))
    cmyk = np.clip(rng.normal(128, 60, (20, 21, 4)), 0, 255)
    path = tmp_path / "cmyk.jpg"
    jpeg_writer(path, cmyk, sampling="1,1,1,1,1,1,1,1")
    files["cmyk"] = (path, (20, 21))
    png = make_png(rng.integers(0, 256, (30, 31, 3)), 2, 8)
    for frac in (0.5, 0.9):
        path = tmp_path / f"png_cut{int(frac * 100)}.png"
        path.write_bytes(png[:int(len(png) * frac)])
        files[path.stem] = (path, (30, 31))
    for where in ("IHDR", "IDAT", "tRNS"):
        path = tmp_path / f"png_bad_{where}_crc.png"
        path.write_bytes(make_png(
            rng.integers(0, 256, (30, 31, 3)), 2, 8, n_idat=2,
            trns=struct.pack(">HHH", 1, 2, 3) if where == "tRNS" else None,
            bad_crc=where))
        files[path.stem] = (path, (30, 31))
    return files


DAMAGED = {"baseline_cut50": 0, "baseline_cut90": 0, "restart_cut50": 0,
           "restart_cut90": 0, "progressive_cut50": 0,
           "progressive_cut90": 0, "cmyk": 1, "png_cut50": 1,
           "png_cut90": 1, "png_bad_IHDR_crc": 1, "png_bad_IDAT_crc": 1,
           "png_bad_tRNS_crc": 0}


@pytest.mark.parametrize("name", sorted(DAMAGED))
def test_damaged_files_as_the_reference_pool(tmp_path, jpeg_writer, name):
    """A truncated JPEG decodes (libjpeg ends the stream itself and fills
    the rest: the same bytes here), and a truncated progressive one gets
    libjpeg's block smoothing; a truncated PNG, a bad critical CRC and a
    CMYK JPEG fail (zeros); a bad CRC on tRNS drops the chunk."""
    path, hw = damaged_files(jpeg_writer, tmp_path)[name]
    failed, _ = assert_same(path, hw)
    assert failed == DAMAGED[name]


OVERSIZED_PROBE = """
import sys
import numpy as np
from znicz_tpu_torch.native import ImagePipeline


def peak():  # this process's peak resident bytes (getrusage's ru_maxrss
    # carries the parent's over exec)
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmHWM:"):
                return int(line.split()[1]) * 1024


pipe = ImagePipeline(1)
out = np.full((1, 4, 4, 3), 7, np.uint8)
before = peak()
pipe.submit([sys.argv[1]], out, out_hw=(4, 4))
failed = pipe.wait()
grew = peak() - before
pipe.close()
print(failed, int(out.any()), grew)
"""


def test_oversized_header_fails_holding_only_the_output(tmp_path):
    """A 4000 x 4000 16-bit RGBA header over a few rows of image data:
    both pools fail it.  The decoder inflates, unfilters and converts a
    row at a time into the RGB output (48 MB here, what libpng's caller
    allocates), so the decode's peak memory stays under twice that; a
    decoder holding the whole inflated image and its samples first
    would take 256 MB more."""
    w = h = 4000
    rows = b"".join(b"\0" + bytes(8 * w) for _ in range(3))
    path = tmp_path / "oversized.png"
    path.write_bytes(
        b"\x89PNG\r\n\x1a\n"
        + png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 6, 0, 0, 0))
        + png_chunk(b"IDAT", zlib.compress(rows, 9))
        + png_chunk(b"IEND", b""))
    assert len(path.read_bytes()) < 200
    want, want_failed = decode(RefPipeline, path, (4, 4))
    assert want_failed == 1 and not want.any()
    assert ImagePipeline.available(), ImagePipeline.build_error()
    repo = Path(native.__file__).resolve().parents[2]
    proc = subprocess.run(
        [sys.executable, "-c", OVERSIZED_PROBE, str(path)],
        capture_output=True, text=True, cwd=repo,
        env={**os.environ, "PYTHONPATH": str(repo)})
    assert proc.returncode == 0, proc.stderr
    failed, nonzero, grew = map(int, proc.stdout.split())
    assert (failed, nonzero) == (1, 0)
    assert grew < 2 * w * h * 3, grew


def test_truncated_progressive_jpeg_at_each_scan(tmp_path):
    """Cut at the start of each scan in turn: each a partial progression
    that libjpeg completes with block smoothing (DC-only blocks
    interpolated from their 5x5 neighbourhood, coarse AC estimated)."""
    rng = np.random.default_rng(9)
    for mode, kwargs in (("RGB", dict(subsampling=2)), ("RGB", {}),
                         ("L", {})):
        img = texture(rng, 53, 70, 1 if mode == "L" else 3)
        data = pillow_jpeg(img, quality=80, progressive=True, **kwargs)
        starts = [i for i in range(len(data) - 1)
                  if data[i] == 0xFF and data[i + 1] == 0xDA]
        assert len(starts) > 3
        for k, start in enumerate(starts[1:]):
            path = tmp_path / f"{mode}{kwargs}_{k}.jpg"
            path.write_bytes(data[:start])
            failed, _ = assert_same(path, (53, 70))
            assert failed == 0


def test_arithmetic_coding_is_refused(tmp_path, jpeg_writer):
    """ROADMAP C22: the system's libjpeg decodes arithmetic-coded
    frames (SOF9, SOF10); the port's decoder refuses them, so its pool
    counts such a file failed and zero-fills it."""
    img = texture(np.random.default_rng(10), 24, 30)
    for progressive in (0, 1):
        path = tmp_path / f"arith{progressive}.jpg"
        jpeg_writer(path, img, arith=1, progressive=progressive)
        want, want_failed = decode(RefPipeline, path, (24, 30))
        got, got_failed = decode(ImagePipeline, path, (24, 30))
        assert want_failed == 0 and want.any()
        assert got_failed == 1 and not got.any()


# --------------------------------------------------------------- the build
def test_the_library_links_zlib_and_no_image_library():
    assert ImagePipeline.available(), ImagePipeline.build_error()
    assert native._LIBS == ("-lz",)
    readelf = shutil.which("readelf")
    assert readelf
    dyn = subprocess.run([readelf, "-d", str(native.library_path())],
                         capture_output=True, text=True, check=True).stdout
    needed = [line.split("[")[1].rstrip("]") for line in dyn.splitlines()
              if "(NEEDED)" in line]
    assert any(n.startswith("libz.") for n in needed), needed
    assert not [n for n in needed if "jpeg" in n or "png" in n], needed
    src = (Path(native.__file__).parent / "pipeline.cpp").read_text()
    assert "jpeglib.h" not in src and "png.h" not in src


def test_library_path_follows_every_source(tmp_path, monkeypatch):
    copies = []
    for src in native.SOURCES:
        dst = tmp_path / src.name
        shutil.copy(src, dst)
        copies.append(dst)
    header = Path(native.__file__).parent / "image_decode.h"
    shutil.copy(header, tmp_path / header.name)
    monkeypatch.setattr(native, "SOURCES", tuple(copies))
    monkeypatch.setattr(native, "_HEADERS", (tmp_path / header.name,))
    base = native.library_path()
    for path in (*copies, tmp_path / header.name):
        text = path.read_text()
        path.write_text(text + "\n// changed\n")
        assert native.library_path() != base, path.name
        path.write_text(text)
        assert native.library_path() == base


# ----------------------------------------------- the loader, graphed (C23)
def tiny_alexnet(cfg):
    """``alexnet.layers``'s kinds in order (LRN, pooling, dropout, the
    softmax head) at a few channels."""
    gd = {"learning_rate": 0.02, "gradient_moment": 0.9}
    pool = {"kx": 3, "ky": 3, "sliding": (2, 2)}
    lrn = {"n": 5, "alpha": 1e-4, "beta": 0.75, "k": 2.0}
    return [{"type": "conv_str", "->": {"n_kernels": 4, "kx": 5, "ky": 5,
                                        "sliding": (2, 2),
                                        "weights_stddev": 0.1}, "<-": gd},
            {"type": "norm", "->": dict(lrn)},
            {"type": "max_pooling", "->": dict(pool)},
            {"type": "all2all_str", "->": {"output_sample_shape": 8,
                                           "weights_stddev": 0.1}, "<-": gd},
            {"type": "dropout", "->": {"dropout_ratio": 0.5}},
            {"type": "softmax", "->": {"output_sample_shape":
                                       cfg["n_classes"],
                                       "weights_stddev": 0.1}, "<-": gd}]


def test_file_image_loader_captures_and_replays(tmp_path, monkeypatch):
    """C23: ``ImageLoader`` kept its decode buffers in ``_buffers``, the
    name under which the region's capture (``_bindings``) reads an
    ``nn.Module``'s buffer table, so the first capture of a step fed by
    ``FileImageLoader`` or ``ImageLoader`` raised ``AttributeError``
    on the card (``imagenet`` could not train there).  With a stand-in
    for the CUDA graph API: the train step is captured once and
    replayed, and the batch reaches ``minibatch_raw`` in place."""
    replays = []

    class Graph:
        def replay(self):
            replays.append(self)

    class Stream:
        def wait_stream(self, other):
            pass

    monkeypatch.setattr(torch.cuda, "Stream", lambda *a: Stream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(JitRegion, "graphed",
                        property(lambda self: self.mark is None))
    monkeypatch.setattr(imagenet, "layers", tiny_alexnet)
    rng = np.random.default_rng(11)
    for c in range(3):
        os.makedirs(tmp_path / f"c{c}")
        for i in range(8):
            path = tmp_path / f"c{c}" / f"{i}.jpg"
            path.write_bytes(pillow_jpeg(texture(rng, 44, 48), quality=90))
    reset_root()
    prng.seed_all(3)
    wf = imagenet.build(train_dir=str(tmp_path), image_size=35,
                        resize_size=40, n_classes=3, minibatch_size=6,
                        decode_threads=2)
    wf.initialize(device="cpu")
    try:
        loader = wf.loader
        raw = loader.minibatch_raw.devmem
        for _ in range(4):
            wf.step()
            assert loader.minibatch_class == TRAIN
            assert loader.minibatch_raw.devmem is raw
        assert loader.decoder == "native"
        assert wf.region.captures == 1 and len(replays) >= 3
    finally:
        wf.stop()
        reset_root()
