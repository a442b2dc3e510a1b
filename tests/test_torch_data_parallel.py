"""The port's data parallelism on the CPU: two ranks in a gloo group
(tests/torch_dp_worker.py, spawned here, each on half of every batch)
against one process on the whole batch: a Semantic LM train step with
dropout and the forgetful mask (the draws of the whole batch, cut to each
rank's rows), two SoundStreamTrainer steps whose quantizers start
uninitialised (kmeans over every rank's rows, the EMA counts and sums
summed over the ranks, dead codes revived, the gradient penalty), rank 0
alone saving the checkpoint, LFQ's entropy loss over the whole batch's mean
bit probabilities and its gradients, and a batch-sharded Semantic
`generate`, whose ids are the unsharded run's. Also `parallel.mesh`'s helpers outside a group.

Tolerances: losses 1e-5 relative; the parameters after the steps (as one
vector) and each of the quantizers' buffers by relative norm 1e-5 (the sums
over the ranks add in another order than one process's sums); generated ids
identical."""
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from audiolm_pytorch_tpu_torch.parallel import mesh as dp

WORKER = Path(__file__).resolve().parent / "torch_dp_worker.py"
REL = 1e-5


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp")
    port = _free_port()
    cmds = [[sys.executable, str(WORKER), "--world", "1", "--out", str(out)]] + [
        [sys.executable, str(WORKER), "--rank", str(r), "--world", "2", "--port", str(port),
         "--out", str(out)] for r in range(2)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    try:
        logs = [p.communicate(timeout=100)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return out, {name: torch.load(out / f"{name}.pt", weights_only=False)
                 for name in ("single", "rank0", "rank1")}


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def _states_close(got, want, what, buffers=()):
    """The floating state as one vector by relative norm (Adam turns the
    float32 noise of a near-zero gradient element into an update of +-lr,
    so a leaf that starts at zero, a hyper-connection's dynamic weights,
    differs by 1e-4 of its own norm between two correct runs), each buffer
    (the quantizers' EMA state, no Adam) on its own, the rest exactly."""
    assert set(got) == set(want)
    floats = [n for n, w in want.items() if w.is_floating_point() and n not in buffers]
    gap = _rel(torch.cat([got[n].reshape(-1) for n in floats]),
               torch.cat([want[n].reshape(-1) for n in floats]))
    assert gap <= REL, (what, gap)
    for name, w in want.items():
        if name in buffers and w.is_floating_point():
            assert _rel(got[name], w) <= REL, (what, name, _rel(got[name], w))
        elif not w.is_floating_point():
            assert torch.equal(got[name], w), (what, name)


def _codec_buffers(state):
    return [n for n in state if n.startswith("rq.") and
            n.rsplit(".", 1)[-1] in ("codebook", "embed_avg", "cluster_size")]


def test_two_ranks_train_as_one_process(runs):
    out, res = runs
    single = res["single"]
    for rank in ("rank0", "rank1"):
        r = res[rank]
        np.testing.assert_allclose(r["semantic_loss"], single["semantic_loss"], rtol=REL)
        _states_close(r["semantic_params"], single["semantic_params"], "semantic")
        for got, want in zip(r["codec_logs"], single["codec_logs"]):
            for key, value in want.items():
                np.testing.assert_allclose(got[key], value, rtol=REL, atol=1e-7, err_msg=key)
        buffers = _codec_buffers(single["codec_state"])
        _states_close(r["codec_state"], single["codec_state"], "codec", buffers)
        _states_close(r["codec_ema"], single["codec_ema"], "codec ema", buffers)
        for got, want in zip(r["lfq"], single["lfq"]):  # loss, input and weight gradients
            assert _rel(got, want) <= REL
        assert torch.equal(r["replicated"], torch.zeros(3))  # rank 0's
    # the quantizers trained: kmeans ran and the EMA moved the codebooks
    assert bool(single["codec_state"]["rq.rvqs.0.layers.0.initted"])
    # rank 0 alone wrote the checkpoint, and the metrics once a step
    assert res["rank0"]["saved"] == res["rank1"]["saved"] == ["soundstream.2.ckpt.npz"]
    logs = (out / "results_dp" / "metrics.jsonl").read_text().splitlines()
    assert len(logs) == 2


def test_batch_sharded_generation_equals_the_unsharded_run(runs):
    _, res = runs
    want = res["single"]["generated"]
    assert want.shape == (4, 12)
    for rank in ("rank0", "rank1"):
        assert torch.equal(res[rank]["generated"], want)


def test_mesh_helpers_do_nothing_outside_a_group():
    x = torch.arange(6.0).reshape(3, 2)
    with dp.data_parallel(None) as scope:
        assert scope is None and dp.current() is None
        assert dp.all_reduce_sum(x) is x and dp.gather_rows(x) is x
        assert dp.local_rows(lambda s: torch.zeros(s), (3, 2)).shape == (3, 2)
        dp.barrier()
    assert dp.is_main() and dp.all_reduce_mean([x])[0] is x
    with pytest.raises(RuntimeError, match="process group"):
        dp.make_mesh()
