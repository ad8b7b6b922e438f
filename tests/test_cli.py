"""End-to-end CLI tests (reference main.cpp-compatible driver, cli.py)."""

import numpy as np
import pytest

from imageencoder_tpu.cli import main
from imageencoder_tpu.models.image import decode_image, encode_image
from imageencoder_tpu.models.video import decode_video
from imageencoder_tpu.utils.quant import QuantMatrix
from tests.oracle import QUANT4, QUANT8

MATRIX = QUANT4
MATRIX8 = QUANT8


def write_conf(path, **kv):
    path.write_text("".join(f"{k}={v}\n" for k, v in kv.items()))
    return str(path)


@pytest.fixture()
def image_job(tmp_path):
    rng = np.random.default_rng(0)
    img = np.kron(rng.integers(0, 256, (8, 8)),
                  np.ones((8, 8))).astype(np.uint8)  # 64x64
    raw = tmp_path / "img.raw"
    img.tofile(raw)
    conf = write_conf(tmp_path / "img.conf", rawfile=raw,
                      encfile=tmp_path / "img.enc",
                      decfile=tmp_path / "img.dec", rle=1,
                      quantfile=MATRIX, width=64, height=64,
                      logfile=tmp_path / "img.log")
    return img, conf, tmp_path


def test_cli_image_roundtrip(image_job):
    img, conf, d = image_job
    assert main([conf]) == 0
    enc = (d / "img.enc").read_bytes()
    assert enc == encode_image(img, QuantMatrix.from_file(MATRIX), True,
                               use_huffman=True)
    dec = np.fromfile(d / "img.dec", dtype=np.uint8).reshape(64, 64)
    assert np.array_equal(dec, decode_image(enc))


def test_cli_image_fast_backend(image_job):
    img, conf, d = image_job
    assert main([conf, "--backend", "fast"]) == 0
    dec = np.fromfile(d / "img.dec", dtype=np.uint8)
    assert dec.size == 64 * 64


def test_cli_image_block8(tmp_path, image_job):
    img, _, d = image_job
    conf = write_conf(tmp_path / "img8.conf", rawfile=d / "img.raw",
                      encfile=tmp_path / "img8.enc",
                      decfile=tmp_path / "img8.dec", rle=1,
                      quantfile=MATRIX8, width=64, height=64,
                      logfile=tmp_path / "img8.log")
    assert main([conf, "--block-size", "8", "--norm", "ortho"]) == 0
    assert (tmp_path / "img8.dec").stat().st_size == 64 * 64


@pytest.fixture()
def video_job(tmp_path):
    from tests.test_video_parity import make_video

    data, _ = make_video(w=64, h=64, n=6, seed=4)
    raw = tmp_path / "vid.yuv"
    raw.write_bytes(data)
    conf = write_conf(tmp_path / "vid.conf", rawfile=raw,
                      encfile=tmp_path / "vid.enc",
                      decfile=tmp_path / "vid.dec", rle=1,
                      quantfile=MATRIX, width=64, height=64, gop=3,
                      merange=16, logfile=tmp_path / "vid.log",
                      motioncompensation=1)
    return data, conf, tmp_path


def test_cli_video_roundtrip_with_workers(video_job):
    data, conf, d = video_job
    assert main([conf, "--workers", "2"]) == 0
    enc = (d / "vid.enc").read_bytes()
    dec = (d / "vid.dec").read_bytes()
    want, params, _ = decode_video(enc)
    assert dec == want and params.frame_count == 6


def test_cli_video_decode_only_without_decfile_fails(tmp_path, video_job):
    data, _, d = video_job
    conf = write_conf(tmp_path / "nodec.conf", rawfile=d / "vid.yuv",
                      encfile=d / "vid.enc", rle=1, quantfile=MATRIX,
                      width=64, height=64, gop=3, merange=16,
                      logfile=tmp_path / "n.log", motioncompensation=1)
    assert main([conf, "--mode", "decode"]) == 4


def test_cli_video_decoder_schema(video_job, tmp_path):
    data, conf, d = video_job
    assert main([conf, "--mode", "encode"]) == 0
    dconf = write_conf(tmp_path / "dec.conf", encfile=d / "vid.enc",
                       decfile=tmp_path / "out.yuv", motioncompensation=0,
                       logfile=tmp_path / "d.log")
    assert main([dconf]) == 0
    assert (tmp_path / "out.yuv").stat().st_size == len(data)


def test_cli_bad_config(tmp_path):
    assert main([str(tmp_path / "nope.conf")]) == 2
    bad = write_conf(tmp_path / "bad.conf", foo="bar")
    assert main([bad]) == 3


def test_cli_trace_prints_stage_table(image_job, capsys):
    img, conf, d = image_job
    assert main([conf, "--trace"]) == 0
    out = capsys.readouterr().err
    assert "[trace:image encode]" in out and "fused encode" in out
    assert "[trace:image decode]" in out and (
        "idct" in out or "extract" in out)
    assert "total:" in out
