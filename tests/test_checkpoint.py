"""GOP checkpoint/resume and multi-host GOP sharding: outputs must be
byte-identical to the straight encoder."""

import json

import numpy as np
import pytest

from imageencoder_tpu.models.video import decode_video, encode_video
from imageencoder_tpu.parallel.distributed import (assemble, encode_gops,
                                                   gop_assignment)
from imageencoder_tpu.utils.checkpoint import encode_video_checkpointed
from imageencoder_tpu.utils.quant import QuantMatrix

from tests.test_video_parity import make_video
from tests.oracle import QUANT4

MATRIX = QUANT4


@pytest.fixture(scope="module")
def quant():
    return QuantMatrix.from_file(MATRIX)


@pytest.fixture(scope="module")
def video():
    return make_video(n=10, seed=13, smooth=False)[0]


def test_checkpoint_matches_straight_encode(tmp_path, quant, video):
    straight = encode_video(video, 64, 64, quant, True, 4, 16,
                            use_huffman=True)
    ck = encode_video_checkpointed(video, 64, 64, quant, True, 4, 16,
                                   str(tmp_path / "ck"), use_huffman=True)
    assert ck == straight


def test_resume_after_partial(tmp_path, quant, video):
    d = tmp_path / "ck2"
    full = encode_video_checkpointed(video, 64, 64, quant, True, 4, 16,
                                     str(d), use_huffman=False)
    # Remove one segment; resume must regenerate only it and agree.
    (d / "gop_000001.seg").unlink()
    (d / "gop_000001.json").unlink()
    again = encode_video_checkpointed(video, 64, 64, quant, True, 4, 16,
                                      str(d), use_huffman=False)
    assert again == full
    dec, params, _ = decode_video(again)
    assert params.frame_count == 10


def test_mismatched_job_rejected(tmp_path, quant, video):
    d = tmp_path / "ck3"
    encode_video_checkpointed(video, 64, 64, quant, True, 4, 16, str(d),
                              use_huffman=False)
    with pytest.raises(ValueError):
        encode_video_checkpointed(video, 64, 64, quant, True, 5, 16, str(d),
                                  use_huffman=False)


def test_distributed_gop_sharding_assembles_identically(quant, video):
    n_hosts = 3
    n_gops = 3  # 10 frames, gop 4
    segments = {}
    for host in range(n_hosts):
        ids = gop_assignment(n_gops, n_hosts, host)
        segments.update(encode_gops(video, 64, 64, quant, True, 4, 16, ids))
    assert sorted(segments) == list(range(n_gops))
    out = assemble(segments, 10, 64, 64, quant, True, 4, 16,
                   use_huffman=True)
    straight = encode_video(video, 64, 64, quant, True, 4, 16,
                            use_huffman=True)
    assert out == straight


def test_assignment_balanced():
    for n in (1, 2, 5):
        ids = [gop_assignment(11, n, h) for h in range(n)]
        flat = sorted(i for sub in ids for i in sub)
        assert flat == list(range(11))
        sizes = [len(s) for s in ids]
        assert max(sizes) - min(sizes) <= 1


def test_corrupt_segment_detected_and_reencoded(tmp_path, quant, video):
    """Fault injection: a bit-flipped segment must be detected (CRC) and
    re-encoded on resume — never silently spliced into the stream."""
    d = tmp_path / "ck4"
    full = encode_video_checkpointed(video, 64, 64, quant, True, 4, 16,
                                     str(d), use_huffman=False)
    seg_p = d / "gop_000001.seg"
    raw = bytearray(seg_p.read_bytes())
    raw[len(raw) // 2] ^= 0x40  # flip one bit mid-segment
    seg_p.write_bytes(bytes(raw))
    again = encode_video_checkpointed(video, 64, 64, quant, True, 4, 16,
                                      str(d), use_huffman=False)
    assert again == full
    # And the on-disk segment was actually repaired (CRC now matches).
    import zlib
    info = json.loads((d / "gop_000001.json").read_text())
    assert info["crc32"] == zlib.crc32((d / "gop_000001.seg").read_bytes())


def test_truncated_segment_detected(tmp_path, quant, video):
    d = tmp_path / "ck5"
    full = encode_video_checkpointed(video, 64, 64, quant, True, 4, 16,
                                     str(d), use_huffman=False)
    seg_p = d / "gop_000000.seg"
    seg_p.write_bytes(seg_p.read_bytes()[:-3])  # crash mid-write
    again = encode_video_checkpointed(video, 64, 64, quant, True, 4, 16,
                                      str(d), use_huffman=False)
    assert again == full


def test_malformed_segment_meta_detected(tmp_path, quant, video):
    d = tmp_path / "ck6"
    full = encode_video_checkpointed(video, 64, 64, quant, True, 4, 16,
                                     str(d), use_huffman=False)
    (d / "gop_000002.json").write_text("{not json")
    again = encode_video_checkpointed(video, 64, 64, quant, True, 4, 16,
                                      str(d), use_huffman=False)
    assert again == full


def test_numerics_mismatch_rejected(tmp_path, quant, video):
    """Resuming with a different norm/backend must be rejected: those change
    payload bits and would splice stale numerics."""
    d = tmp_path / "ck7"
    encode_video_checkpointed(video, 64, 64, quant, True, 4, 16, str(d),
                              use_huffman=False, norm="reference")
    with pytest.raises(ValueError):
        encode_video_checkpointed(video, 64, 64, quant, True, 4, 16, str(d),
                                  use_huffman=False, norm="ortho")


def test_distributed_lost_host_detected_and_recovered(quant, video):
    """Elastic recovery: a host's lost GOP share is DETECTED at assembly
    (no silent bad splice) and re-encoding just the missing ids on a
    survivor reproduces the exact stream."""
    from imageencoder_tpu.parallel.distributed import missing_gops

    n_hosts, n_gops = 3, 3
    segments = {}
    for host in range(n_hosts):
        if host == 1:
            continue  # host 1 "crashed" mid-job
        ids = gop_assignment(n_gops, n_hosts, host)
        segments.update(encode_gops(video, 64, 64, quant, True, 4, 16, ids))

    lost = missing_gops(segments, 10, 4)
    assert lost == gop_assignment(n_gops, n_hosts, 1)
    with pytest.raises(ValueError):
        assemble(segments, 10, 64, 64, quant, True, 4, 16)

    # Elastic reassignment: any survivor re-encodes exactly the lost ids.
    segments.update(encode_gops(video, 64, 64, quant, True, 4, 16, lost))
    out = assemble(segments, 10, 64, 64, quant, True, 4, 16)
    straight = encode_video(video, 64, 64, quant, True, 4, 16,
                            use_huffman=True)
    assert out == straight


def test_distributed_corrupt_segment_detected(quant, video):
    segments = encode_gops(video, 64, 64, quant, True, 4, 16, [0, 1, 2])
    data, nbits = segments[2]
    segments[2] = (data[:2], nbits)  # truncated mid-transfer
    from imageencoder_tpu.parallel.distributed import missing_gops

    assert missing_gops(segments, 10, 4) == [2]
    with pytest.raises(ValueError):
        assemble(segments, 10, 64, 64, quant, True, 4, 16)
