"""Port: the multi-process collectives. Two OS processes
(tests/torch_multihost_worker.py), two CPU shards each, join one gloo
process group through parallel/mesh.py::initialize_multihost on 127.0.0.1
and run the sharded screen (an all_gather of the scores) and the summed
elect (an all_reduce) over the global 4-shard mesh. Both processes must
give the same results, equal to the JAX package's serial batch_score and
device_elect and to the serial ConsensusRef.elect on the JAX worker's
inputs. A worker that hangs fails the test at its timeout."""

import numpy as np

from pacbioassembly_tpu.align.scan import batch_score
from pacbioassembly_tpu.consensus import ConsensusRef
from pacbioassembly_tpu.parallel import device_elect

from torch_multihost_worker import inputs, run_workers
from torch_parity import FIELDS


def test_two_process_mesh_matches_serial(tmp_path):
    r0, r1 = run_workers(tmp_path)
    assert list(r0["devices"]) == ["cpu"] * 4
    for k in ("sel", "sup", "total") + FIELDS:
        np.testing.assert_array_equal(r0[k], r1[k], k)

    x = inputs()
    L = x["L"]
    want = device_elect(x["ops"], x["vals"], x["start"], x["fwd"], x["en"], L)
    for f in ("sel", "sup", "total"):
        np.testing.assert_array_equal(r0[f], np.asarray(getattr(want, f)), f)
    ref = ConsensusRef(np.zeros(L, np.uint8), capacity=3 * L)
    base = [getattr(ref, f)[ref.pre : ref.post].copy() for f in ("sel", "sup", "total")]
    for i in range(len(x["start"])):
        live = x["ops"][i] != 0
        ref.elect(int(x["start"][i]), x["ops"][i][live], x["vals"][i][live], bool(x["fwd"][i]))
    for f, b in zip(("sel", "sup", "total"), base):
        np.testing.assert_array_equal(r0[f], getattr(ref, f)[ref.pre : ref.post] - b, f)

    LA = x["a"].shape[1]
    single = batch_score(x["a"], x["la"], x["b"], x["lb"], la_max=LA, w_max=x["W"], ratio=0.3)
    acc = np.asarray(single.accept)
    np.testing.assert_array_equal(r0["accept"], acc)
    assert acc.sum() >= 4
    np.testing.assert_array_equal(r0["dp_rows"], np.asarray(single.dp_rows))
    for f in ("cost", "matlen_a", "matlen_b", "diag_cost"):
        np.testing.assert_array_equal(r0[f][acc], np.asarray(getattr(single, f))[acc], f)
