"""Multi-process GOP distribution: real worker processes encode disjoint
GOP sets; the root assembles a stream byte-identical to a single-process
encode.  (The transport here is a shared directory; parallel/distributed.py
works with any transport, e.g. a network file system between hosts.)"""

import pathlib
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest

from imageencoder_tpu.models.video import encode_video
from imageencoder_tpu.parallel.distributed import assemble
from imageencoder_tpu.utils.quant import QuantMatrix

from tests.oracle import QUANT4
from tests.test_video_parity import make_video

MATRIX = QUANT4
REPO = str(pathlib.Path(__file__).resolve().parent.parent)

WORKER = r"""
import pickle, sys
sys.path.insert(0, {repo!r})
import numpy as np
from imageencoder_tpu.parallel.distributed import encode_gops, gop_assignment
from imageencoder_tpu.utils.quant import QuantMatrix

host, n_hosts, n_gops = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
data = open(sys.argv[4], 'rb').read()
quant = QuantMatrix.from_file({matrix!r})
ids = gop_assignment(n_gops, n_hosts, host)
segs = encode_gops(data, 64, 64, quant, True, 4, 16, ids)
with open(sys.argv[5], 'wb') as f:
    pickle.dump(segs, f)
"""


def test_two_worker_processes_assemble_identically(tmp_path):
    data, _ = make_video(n=10, seed=17, smooth=False)
    raw = tmp_path / "v.raw"
    raw.write_bytes(data)
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER.format(repo=REPO, matrix=MATRIX))

    n_hosts, n_gops = 2, 3
    procs = []
    outs = []
    for h in range(n_hosts):
        out = tmp_path / f"seg{h}.pkl"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, str(worker), str(h), str(n_hosts), str(n_gops),
             str(raw), str(out)]))
    for p in procs:
        assert p.wait(timeout=300) == 0

    segments = {}
    for out in outs:
        segments.update(pickle.loads(out.read_bytes()))
    assert sorted(segments) == list(range(n_gops))

    quant = QuantMatrix.from_file(MATRIX)
    assembled = assemble(segments, 10, 64, 64, quant, True, 4, 16,
                         use_huffman=True)
    straight = encode_video(data, 64, 64, quant, True, 4, 16,
                            use_huffman=True)
    assert assembled == straight


# Real jax.distributed bring-up: two OS processes form a 2-process CPU
# cluster (gloo collectives), each encodes its GOP share, the segment maps
# ride a cross-process all-gather (parallel/distributed.gather_segments —
# the DCN hop), and rank 0 assembles.  This executes distributed.py's
# initialize() for real, unlike the file-transport test above.
JD_WORKER = r"""
import sys
sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_cpu_collectives_implementation", "gloo")

pid, port = int(sys.argv[1]), sys.argv[2]
from imageencoder_tpu.parallel.distributed import (
    assemble, encode_gops, gather_segments, gop_assignment, initialize)
from imageencoder_tpu.utils.quant import QuantMatrix

initialize(coordinator_address="localhost:" + port, num_processes=2,
           process_id=pid)
assert jax.process_count() == 2, jax.process_count()

data = open(sys.argv[3], 'rb').read()
quant = QuantMatrix.from_file({matrix!r})
n_gops = 3
ids = gop_assignment(n_gops, 2, pid)
segs = encode_gops(data, 64, 64, quant, True, 4, 16, ids)
full = gather_segments(segs, n_gops)
assert sorted(full) == list(range(n_gops)), sorted(full)
if pid == 0:
    out = assemble(full, 10, 64, 64, quant, True, 4, 16, use_huffman=True)
    with open(sys.argv[4], 'wb') as f:
        f.write(out)
jax.distributed.shutdown()
"""


def test_jax_distributed_two_process_encode(tmp_path):
    data, _ = make_video(n=10, seed=17, smooth=False)
    raw = tmp_path / "v.raw"
    raw.write_bytes(data)
    worker = tmp_path / "worker.py"
    worker.write_text(JD_WORKER.format(repo=REPO, matrix=MATRIX))
    out = tmp_path / "rank0.bin"

    with socket.socket() as s:  # pick a free coordinator port
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(h), str(port), str(raw), str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for h in range(2)]
    logs = [p.communicate(timeout=300)[0].decode() for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)

    quant = QuantMatrix.from_file(MATRIX)
    straight = encode_video(data, 64, 64, quant, True, 4, 16,
                            use_huffman=True)
    assert out.read_bytes() == straight
