"""A module fixture's value computed once per test run, for every
pytest-xdist worker.

Under ``-n`` each worker that receives one of a module's tests runs the
module's fixtures again, and the port's parity fixtures spend most of their
time building and running the JAX reference.  ``shared(tmp_path_factory,
key, compute)`` runs ``compute()`` in the first worker that asks and
pickles the value under the run's common base temporary directory; the
other workers load the pickle (one that asks while another computes waits
for it).  Outside xdist it is ``compute()``.  The value must pickle: numpy
arrays, tensors, numbers and containers of them.
"""
import fcntl
import os
import pickle

__all__ = ["shared"]


def shared(tmp_path_factory, key, compute):
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return compute()
    path = tmp_path_factory.getbasetemp().parent / ("shared-%s.pkl" % key)
    with open(str(path) + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if path.is_file():
                with open(path, "rb") as f:
                    return pickle.load(f)
            value = compute()
            tmp = path.with_suffix(".tmp")
            with open(tmp, "wb") as f:
                pickle.dump(value, f)
            os.replace(tmp, path)
            return value
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
