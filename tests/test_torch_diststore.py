"""The port's ``DistSampleStore`` (``hydragnn_tpu_torch/data/diststore.py``)
against the JAX package's (``hydragnn_tpu/data/diststore.py``): the same
wire protocol both ways (a sample packed by one package unpacks in the
other bit for bit; a port client fetches from a JAX server over loopback
TCP and a JAX client from a port server), the local lookups, the
ownership arithmetic, the LRU cache and the refusal of an index past a
shard. Then two ranks of a gloo group (two processes on this machine,
the addresses exchanged with ``all_gather_object``): each owns half of
the seeded samples and fetches the other's, bit-equal to its own copy of
the data."""

import inspect
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest

from hydragnn_tpu.data.diststore import DistSampleStore as JaxStore
from hydragnn_tpu.data.diststore import _pack_sample as jax_pack
from hydragnn_tpu.data.diststore import _unpack_sample as jax_unpack

from hydragnn_tpu_torch.data.diststore import DistSampleStore, _pack_sample, _unpack_sample

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("x", "pos", "edge_index", "edge_attr", "graph_y")


def _samples(n, seed):
    """``n`` seeded BCC graphs prepared by the port (the train split)."""
    from hydragnn_tpu_torch.api import prepare_config_and_samples
    from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data
    from hydragnn_tpu_torch.flagship import flagship_config

    cfg = flagship_config(hidden_dim=8, num_conv_layers=2, batch_size=4, num_epoch=1)
    tr, _, _, _ = prepare_config_and_samples(cfg, deterministic_graph_data(
        number_configurations=n, seed=seed, unit_cell_x_range=(2, 3), unit_cell_y_range=(2, 3),
        unit_cell_z_range=(2, 3)))
    return tr


def _assert_same(a, b):
    for f in FIELDS:
        va, vb = getattr(a, f), getattr(b, f)
        assert (va is None) == (vb is None), f
        if va is not None:
            assert np.asarray(va).dtype == np.asarray(vb).dtype and np.array_equal(va, vb), f
    for d in ("graph_targets", "node_targets"):
        assert sorted(getattr(a, d)) == sorted(getattr(b, d))
        for k in getattr(a, d):
            assert np.array_equal(getattr(a, d)[k], getattr(b, d)[k]), (d, k)


def test_pack_unpack_round_trips_across_the_packages():
    s = _samples(6, 9)[0]
    for pack, unpack in ((_pack_sample, _unpack_sample), (_pack_sample, jax_unpack), (jax_pack, _unpack_sample)):
        _assert_same(unpack(pack(s)), s)
    assert pickle.loads(_pack_sample(s)).keys() == pickle.loads(jax_pack(s)).keys()


def test_local_store_and_ownership_match_jax():
    samples = _samples(12, 9)
    store, jstore = DistSampleStore(samples), JaxStore(samples)
    assert len(store) == len(jstore) == len(samples)
    for i in (0, len(samples) // 2, len(samples) - 1):
        assert store.get(i) is samples[i] and jstore.get(i) is samples[i]
    with pytest.raises(IndexError):
        store.get(len(samples))
    store.close()
    jstore.close()
    counts = [4, 6, 2]
    store, jstore = DistSampleStore(samples[:4], global_counts=counts), JaxStore(samples[:4], global_counts=counts)
    assert len(store) == len(jstore) == 12
    assert [store.owner_of(i) for i in range(12)] == [jstore.owner_of(i) for i in range(12)]
    assert [store.owner_of(i) for i in (0, 3, 4, 9, 10)] == [0, 0, 1, 1, 2]
    store.close()
    jstore.close()


@pytest.mark.parametrize("server_pkg", ["jax", "port"])
def test_remote_fetch_over_loopback_across_the_packages(server_pkg):
    """Rank 0 owns global [0, 4) locally; a hand-started peer server owns
    [4, 8), as rank 1 would; the other package is the client."""
    local, remote = _samples(8, 1)[:4], _samples(8, 2)[:4]
    client_cls, server_cls, pack = ((DistSampleStore, JaxStore, jax_pack) if server_pkg == "jax"
                                    else (JaxStore, DistSampleStore, _pack_sample))
    store = client_cls(local, global_counts=[4, 4])
    peer = server_cls(remote, global_counts=[4, 4])
    peer._local = [pack(s) for s in remote]  # one process's store pickles nothing: do as rank 1 does
    peer._start_server()
    store._peers = [("127.0.0.1", 0), ("127.0.0.1", peer._server.getsockname()[1])]
    store.rank = 0
    for gi in (4, 6, 7, 4):  # 4 again: from the LRU cache
        _assert_same(store.get(gi), remote[gi - 4])
    assert len(store._cache) == 3
    with pytest.raises(IndexError):
        store._fetch_remote(1, 99)
    store.close()
    peer.close()


def test_lru_cache_is_bounded():
    local, remote = _samples(8, 1)[:2], _samples(8, 2)[:6]
    store = DistSampleStore(local, global_counts=[2, 6], cache_size=2)
    peer = DistSampleStore(remote, global_counts=[2, 6])
    peer._local = [_pack_sample(s) for s in remote]
    peer._start_server()
    store._peers = [("127.0.0.1", 0), ("127.0.0.1", peer._server.getsockname()[1])]
    for gi in (2, 3, 4, 3):
        _assert_same(store.get(gi), remote[gi - 2])
    assert list(store._cache) == [4, 3]  # the least recent (2) went first
    store.close()
    peer.close()


_RANK = r"""
import os, sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch.distributed as dist
from hydragnn_tpu_torch.data.diststore import DistSampleStore
FIELDS = {fields!r}
{helpers}

dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + sys.argv[1], world_size=2, rank=int(sys.argv[2]))
rank = dist.get_rank()
every = _samples(40, 5)
half = len(every) // 2
mine = every[:half] if rank == 0 else every[half:]
store = DistSampleStore(mine)
assert len(store) == len(every) and list(store.counts) == [half, len(every) - half]
other = range(half, len(every)) if rank == 0 else range(half)
fetched = 0
for gi in other:
    _assert_same(store.get(gi), every[gi])
    fetched += 1
dist.barrier()  # every fetch served before either server closes
store.close()
dist.destroy_process_group()
print("FETCHED", rank, fetched, flush=True)
"""


def test_two_gloo_ranks_fetch_each_others_samples_bit_equal(tmp_path):
    script = tmp_path / "rank.py"
    helpers = inspect.getsource(_samples) + "\n\n" + inspect.getsource(_assert_same)
    script.write_text(_RANK.format(repo=REPO, fields=FIELDS, helpers=helpers))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = str(sock.getsockname()[1])
    env = dict(os.environ, OMP_NUM_THREADS="1", MASTER_ADDR="127.0.0.1")
    procs = [subprocess.Popen([sys.executable, str(script), port, str(r)], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out[-3000:]
        fetched = [ln.split() for ln in out.splitlines() if ln.startswith("FETCHED")]
        assert fetched and int(fetched[0][2]) >= 16, out[-3000:]
