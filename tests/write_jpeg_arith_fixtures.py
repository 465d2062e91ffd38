"""Write ``tests/torch_jpeg_arith/``: small arithmetic-coded JPEGs
(SOF9, SOF10) and ``digests.json``, the sha256 of the RGB bytes the
reference's pool (``znicz_tpu.native``, libjpeg-turbo) decodes from each
at its own size.

    python tests/write_jpeg_arith_fixtures.py

The files come from ``test_torch_image_decode.py``'s libjpeg writer
(compiled here against the system's libjpeg) over its ``texture``
frames, from fixed seeds, so a rerun writes the same bytes.
``test_committed_arithmetic_files_match_their_digests`` holds the files
to the digests, and ``chip_smoke.py``'s phase 17 (b) decodes them
through the port's pool on the card's host.
"""

import hashlib
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE))

#: name -> (h, w, channels, writer arguments, bytes kept or None)
FIXTURES = {
    "imagenet_420_sof9.jpg": (375, 500, 3, dict(sampling="2,2,1,1,1,1"),
                              None),
    "imagenet_420_sof10.jpg": (333, 500, 3,
                               dict(sampling="2,2,1,1,1,1", progressive=1),
                               None),
    "gray_sof9.jpg": (61, 83, 1, dict(sampling="1,1"), None),
    "gray_sof10.jpg": (61, 83, 1, dict(sampling="1,1", progressive=1),
                       None),
    "444_sof10.jpg": (70, 90, 3, dict(sampling="1,1,1,1,1,1",
                                      progressive=1), None),
    "restart_sof9.jpg": (64, 96, 3, dict(restart=3), None),
    "dac_sof10.jpg": (72, 88, 3, dict(dac=(2, 5, 12), progressive=1),
                      None),
    "truncated_sof10.jpg": (80, 120, 3, dict(progressive=1), 0.6),
}
SEED = 2030


def main() -> int:
    from znicz_tpu.native import ImagePipeline

    import test_torch_image_decode as t
    out = HERE / "torch_jpeg_arith"
    out.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "jpeg_writer.c").write_text(t.JPEG_WRITER)
        exe = tmp / "jpeg_writer"
        subprocess.run(["gcc", "-O1", str(tmp / "jpeg_writer.c"), "-o",
                        str(exe), "-ljpeg"], check=True)
        digests = {}
        for i, (name, (h, w, ch, kw, keep)) in enumerate(FIXTURES.items()):
            img = t.texture(np.random.default_rng(SEED + i), h, w, ch)
            raw = tmp / "frame.raw"
            np.ascontiguousarray(img, np.uint8).tofile(raw)
            sampling = kw.get("sampling", "2,2,1,1,1,1")
            extra = [] if "restart" not in kw and "dac" not in kw else [
                str(kw.get("restart", 0)),
                ",".join(map(str, kw.get("dac", (0, 1, 5))))]
            path = out / name
            subprocess.run([str(exe), str(path), str(raw), str(w), str(h),
                            str(ch), "90", sampling, "1",
                            str(kw.get("progressive", 0)), *extra],
                           check=True)
            if keep is not None:
                data = path.read_bytes()
                path.write_bytes(data[:int(len(data) * keep)])
            pixels, failed = t.decode(ImagePipeline, path, (h, w))
            digests[name] = {"hw": [h, w], "failed": int(failed),
                             "sha256": hashlib.sha256(
                                 pixels.tobytes()).hexdigest()}
    (out / "digests.json").write_text(json.dumps(digests, indent=1) + "\n")
    total = sum(os.path.getsize(out / name) for name in digests)
    print(f"wrote {len(digests)} files, {total} bytes, into {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
