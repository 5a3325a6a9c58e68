"""Binary PGM (P5) image IO.

Writer parity with SaveImage (cudabrot.cu:548-577): header ``P5\\n<w> <h>\\n65535\\n``
followed by big-endian 16-bit pixels. The reference byte-swaps its buffer in
place with a scalar loop and assumes a little-endian host
(cudabrot.cu:563-570); here the swap is a numpy big-endian view,
endian-correct on any host. A reader is included for the test suite (the
reference delegates reading to external tools). A copy of
``cudabrot_tpu.io.pgm`` without its native writer: the same bytes.
"""

from __future__ import annotations

import numpy as np


def write_pgm(path: str, image: np.ndarray) -> None:
    """Write a 16-bit (or 8-bit) grayscale binary PGM."""
    image = np.asarray(image)
    if image.ndim != 2:
        raise ValueError(f"PGM image must be 2-D, got shape {image.shape}")
    if image.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PGM image must be uint8/uint16, got {image.dtype}")
    h, w = image.shape
    if image.dtype == np.uint8:
        maxval, payload = 255, image.tobytes()
    else:
        maxval, payload = 65535, image.astype(">u2").tobytes()
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n{maxval}\n".encode("ascii"))
        f.write(payload)


def read_pgm(path: str) -> np.ndarray:
    """Read a binary (P5) PGM into uint8/uint16."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"P5"):
        raise ValueError(f"{path}: not a binary PGM (P5) file")
    # Header: magic, width, height, maxval — whitespace separated, with
    # optional '#' comment lines.
    fields: list[int] = []
    pos = 2
    while len(fields) < 3:
        while pos < len(data) and data[pos : pos + 1].isspace():
            pos += 1
        if data[pos : pos + 1] == b"#":
            while pos < len(data) and data[pos] != 0x0A:
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos : pos + 1].isspace():
            pos += 1
        fields.append(int(data[start:pos]))
    pos += 1  # single whitespace after maxval
    w, h, maxval = fields
    if maxval > 255:
        arr = np.frombuffer(data, dtype=">u2", count=w * h, offset=pos)
        return arr.reshape(h, w).astype(np.uint16)
    arr = np.frombuffer(data, dtype=np.uint8, count=w * h, offset=pos)
    return arr.reshape(h, w)
