"""Golden-oracle harness around the shipped reference binaries.

The reference repo ships working Linux binaries (bin/encoder, bin/decoder,
Huffman+OpenMP build).  They segfault in teardown on modern glibc — AFTER
writing correct output (uninitialized-pointer delete, ImageBase.cpp:161-165)
— so exit code 139 with complete output files is treated as success.

Binaries read paths relative to CWD, so each run is staged in a temp dir.
"""

from __future__ import annotations

import pathlib
import shutil
import subprocess
import tempfile

import numpy as np

REFERENCE_BIN = pathlib.Path("/root/reference/bin")
# ex*.raw / ex*.conf live next to the reference binaries; the quantization
# matrices are in the tree (tests/fixtures/README.md says what they are).
FIXTURES = REFERENCE_BIN
MATRIX_DIR = pathlib.Path(__file__).resolve().parent / "fixtures"
QUANT4 = str(MATRIX_DIR / "quant4.txt")
QUANT8 = str(MATRIX_DIR / "quant8_annexk.txt")


class ReferenceCodec:
    """Stages and runs the reference encoder/decoder in a scratch dir."""

    def __init__(self, workdir: str | None = None):
        self._tmp = None
        if workdir is None:
            self._tmp = tempfile.TemporaryDirectory(prefix="refcodec_")
            workdir = self._tmp.name
        self.dir = pathlib.Path(workdir)
        for tool in ("encoder", "decoder"):
            dst = self.dir / tool
            if not dst.exists():
                shutil.copy(REFERENCE_BIN / tool, dst)
                dst.chmod(0o755)

    def _run(self, tool: str, conf: pathlib.Path) -> None:
        proc = subprocess.run([f"./{tool}", conf.name], cwd=self.dir,
                              capture_output=True, timeout=600)
        # 139 = teardown segfault after output is written (known benign).
        if proc.returncode not in (0, 139, -11):
            raise RuntimeError(
                f"{tool} failed rc={proc.returncode}: {proc.stderr.decode()[-500:]}")

    def _write_conf(self, name: str, settings: dict) -> pathlib.Path:
        conf = self.dir / f"{name}.conf"
        conf.write_text("".join(f"{k}={v}\n" for k, v in settings.items()))
        return conf

    def stage(self, src: pathlib.Path) -> str:
        dst = self.dir / src.name
        if not dst.exists():
            shutil.copy(src, dst)
        return src.name

    def encode_image(self, raw: np.ndarray, quantfile: str, use_rle: bool,
                     name: str = "job") -> bytes:
        h, w = raw.shape
        raw.astype(np.uint8).tofile(self.dir / f"{name}.raw")
        qname = self.stage(pathlib.Path(quantfile))
        conf = self._write_conf(name, {
            "rawfile": f"{name}.raw", "encfile": f"{name}.enc",
            "decfile": f"{name}_dec.raw", "rle": int(use_rle),
            "quantfile": qname, "width": w, "height": h,
            "logfile": f"{name}.log"})
        self._run("encoder", conf)
        return (self.dir / f"{name}.enc").read_bytes()

    def decode_image(self, enc: bytes, width: int, height: int,
                     quantfile: str, use_rle: bool = True,
                     name: str = "job") -> np.ndarray:
        (self.dir / f"{name}.enc").write_bytes(enc)
        qname = self.stage(pathlib.Path(quantfile))
        # Decoder reads all parameters from the stream; conf still needs the
        # full image schema (main.cpp:34-52).
        conf = self._write_conf(name, {
            "rawfile": f"{name}_unused.raw", "encfile": f"{name}.enc",
            "decfile": f"{name}_dec.raw", "rle": int(use_rle),
            "quantfile": qname, "width": width, "height": height,
            "logfile": f"{name}.log"})
        (self.dir / f"{name}_unused.raw").write_bytes(b"\0" * (width * height))
        self._run("decoder", conf)
        out = np.fromfile(self.dir / f"{name}_dec.raw", dtype=np.uint8)
        return out.reshape(height, width)

    def encode_video(self, raw_yuv: bytes, width: int, height: int,
                     quantfile: str, use_rle: bool, gop: int, merange: int,
                     name: str = "vjob") -> bytes:
        (self.dir / f"{name}.raw").write_bytes(raw_yuv)
        qname = self.stage(pathlib.Path(quantfile))
        conf = self._write_conf(name, {
            "rawfile": f"{name}.raw", "encfile": f"{name}.enc",
            "rle": int(use_rle), "quantfile": qname,
            "width": width, "height": height, "gop": gop, "merange": merange,
            "logfile": f"{name}.log"})
        self._run("encoder", conf)
        return (self.dir / f"{name}.enc").read_bytes()

    def decode_video(self, enc: bytes, motioncomp: bool = True,
                     name: str = "vjob") -> bytes:
        (self.dir / f"{name}.enc").write_bytes(enc)
        conf = self._write_conf(f"{name}_dec", {
            "encfile": f"{name}.enc", "decfile": f"{name}_dec.raw",
            "motioncompensation": int(motioncomp)})
        self._run("decoder", conf)
        return (self.dir / f"{name}_dec.raw").read_bytes()


def fixture_image(name: str) -> np.ndarray:
    """Load bin/exN.raw with dimensions from its conf."""
    conf = dict(line.split("=", 1)
                for line in (FIXTURES / f"{name}.conf").read_text().splitlines()
                if "=" in line)
    w, h = int(conf["width"]), int(conf["height"])
    raw = np.fromfile(FIXTURES / f"{name}.raw", dtype=np.uint8)
    return raw.reshape(h, w)


def fixture_conf(name: str) -> dict:
    return dict(line.split("=", 1)
                for line in (FIXTURES / f"{name}.conf").read_text().splitlines()
                if "=" in line)
