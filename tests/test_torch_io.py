"""The port's mx.io (io.py, image_record.py), native and storage modules
against the JAX package's on CPU.

- NDArrayIter (pad, discard, roll_over over two epochs, shuffle), CSVIter,
  LibSVMIter (dense rows, as the JAX package builds them) and MNISTIter
  on idx files the test writes and on the synthetic stand-in
  (RandomState(99)): batches, pads and provide_* equal; ResizeIter and
  PrefetchingIter (a mid-epoch reset, two sources with renames) equal to
  the JAX package's.
- ImageRecordIter over 2 epochs with shuffle, rand_crop, rand_mirror,
  round_batch padding, part_index/num_parts, label_width 1 and 2: uint8
  pixels (dtype uint8, no normalization) and labels equal to the JAX
  iterator's; with mean/std/scale the normalized float32 data within
  1e-6 of max|ref|.
- The native decoder (a centre-crop configuration): the port's batches
  equal the JAX package's native ones, and within 6 levels of the port's
  PIL path (tests/test_native.py's tolerance: libjpeg against PIL's
  codec); the decoder counts say which produced them.  The port builds
  its own library under mxnet_tpu_torch/_build/ and leaves cpp/ as it
  was (its files' sizes and times before and after a fresh build); with
  a compiler that fails, available() is False and
  load_error() holds the compiler's message.
The port's iterators run on ``tmx.cpu()`` here: NDArrayIter's arrays are
made inside ``with tmx.cpu():``, ImageRecordIter takes ``ctx=``."""
import os
import shutil
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import native as tnative
from mxnet_tpu_torch import recordio as trec
from mxnet_tpu_torch import storage as tstorage
from mxnet_tpu_torch.base import MXNetError

ROOT = Path(__file__).resolve().parents[1]
NORM_REL = 1e-6
NATIVE_LEVELS = 6


def _batches(it, epochs=1):
    out = []
    for e in range(epochs):
        if e:
            it.reset()
        for b in it:
            out.append(([d.asnumpy() for d in b.data],
                        [l.asnumpy() for l in (b.label or [])], b.pad))
    return out


def _same_batches(got, want, rel=0.0):
    assert len(got) == len(want) > 0
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp
        for g, w in zip(gd + gl, wd + wl):
            assert g.shape == w.shape and g.dtype == w.dtype
            if rel:
                np.testing.assert_allclose(
                    g, w, rtol=0, atol=rel * max(1.0, np.abs(w).max()))
            else:
                np.testing.assert_array_equal(g, w)


def _descs(descs):
    return [(d.name, tuple(d.shape)) for d in descs]


# -- NDArrayIter and the file iterators --------------------------------------

def _arrays():
    rng = np.random.RandomState(0)
    return (rng.rand(23, 3, 2).astype(np.float32),
            rng.randint(0, 5, 23).astype(np.float32))


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_ndarray_iter(handle, shuffle):
    x, y = _arrays()
    np.random.seed(4)
    jit = jmx.io.NDArrayIter(x, y, batch_size=5, shuffle=shuffle,
                             last_batch_handle=handle)
    want = _batches(jit, epochs=2)
    np.random.seed(4)
    with tmx.cpu():
        tit = tmx.io.NDArrayIter(x, y, batch_size=5, shuffle=shuffle,
                                 last_batch_handle=handle)
    assert _descs(tit.provide_data) == _descs(jit.provide_data)
    assert _descs(tit.provide_label) == _descs(jit.provide_label)
    _same_batches(_batches(tit, epochs=2), want)


def test_ndarray_iter_dict_inputs_and_context():
    x, y = _arrays()
    data = {"a": x, "b": x[:, :1]}
    jit = jmx.io.NDArrayIter(data, {"l": y}, batch_size=4)
    with tmx.cpu():
        tit = tmx.io.NDArrayIter(data, {"l": y}, batch_size=4)
    assert _descs(tit.provide_data) == _descs(jit.provide_data)
    got = _batches(tit)
    _same_batches(got, _batches(jit))
    tit.reset()
    assert next(tit).data[0].context == tmx.cpu()
    with pytest.raises(MXNetError):
        tmx.io.NDArrayIter(None)


def test_csv_iter(tmp_path):
    x, y = _arrays()
    dpath, lpath = tmp_path / "d.csv", tmp_path / "l.csv"
    np.savetxt(dpath, x.reshape(23, -1), delimiter=",")
    np.savetxt(lpath, y, delimiter=",")
    for round_batch in (True, False):
        kw = dict(data_csv=str(dpath), data_shape=(3, 2),
                  label_csv=str(lpath), batch_size=5,
                  round_batch=round_batch)
        with tmx.cpu():
            got = _batches(tmx.io.CSVIter(**kw))
        _same_batches(got, _batches(jmx.io.CSVIter(**kw)))


def test_libsvm_iter_dense_rows(tmp_path):
    path = tmp_path / "d.libsvm"
    rng = np.random.RandomState(1)
    lines = []
    for i in range(9):
        cols = sorted(rng.choice(8, 3, replace=False))
        lines.append("%d %s" % (i % 2, " ".join(
            "%d:%.3f" % (c, rng.rand()) for c in cols)))
    path.write_text("\n".join(lines) + "\n\n")
    with tmx.cpu():
        tit = tmx.io.LibSVMIter(str(path), (8,), batch_size=4)
    got = _batches(tit)
    _same_batches(got, _batches(jmx.io.LibSVMIter(str(path), (8,),
                                                 batch_size=4)))
    assert got[0][0][0].shape == (4, 8)


def _write_idx(tmp_path, n=30):
    rng = np.random.RandomState(2)
    imgs = rng.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, n).astype(np.uint8)
    ip, lp = tmp_path / "img-idx3-ubyte", tmp_path / "lbl-idx1-ubyte"
    ip.write_bytes(struct.pack(">IIII", 2051, n, 28, 28) + imgs.tobytes())
    lp.write_bytes(struct.pack(">II", 2049, n) + labels.tobytes())
    return str(ip), str(lp)


@pytest.mark.parametrize("source", ["files", "synthetic"])
@pytest.mark.parametrize("flat", [False, True])
def test_mnist_iter(tmp_path, source, flat):
    if source == "files":
        image, label = _write_idx(tmp_path)
    else:
        image, label = str(tmp_path / "absent"), str(tmp_path / "absent2")
    kw = dict(image=image, label=label, batch_size=64, flat=flat)
    np.random.seed(6)
    want = _batches(jmx.io.MNISTIter(**kw))
    np.random.seed(6)
    with tmx.cpu():
        got = _batches(tmx.io.MNISTIter(**kw))
    _same_batches(got, want)
    assert len(got) == (1 if source == "files" else 32)


def test_resize_iter():
    x, y = _arrays()
    with tmx.cpu():
        tit = tmx.io.ResizeIter(tmx.io.NDArrayIter(x, y, batch_size=5), 7)
    jit = jmx.io.ResizeIter(jmx.io.NDArrayIter(x, y, batch_size=5), 7)
    _same_batches(_batches(tit, 2), _batches(jit, 2))


def test_prefetching_iter_reset_and_epochs():
    x, y = _arrays()
    with tmx.cpu():
        tpf = tmx.io.PrefetchingIter(tmx.io.NDArrayIter(x, y, batch_size=5))
    jpf = jmx.io.PrefetchingIter(jmx.io.NDArrayIter(x, y, batch_size=5))
    for pf in (tpf, jpf):
        pf.next()
        pf.reset()  # mid-epoch
    _same_batches(_batches(tpf, 2), _batches(jpf, 2))
    tpf.close()
    jpf.close()
    assert all(not w._thread.is_alive() for w in tpf._workers)
    tpf.close()  # idempotent
    with pytest.raises(MXNetError):
        tpf.reset()


def test_prefetching_iter_multi_source_rename():
    x, y = _arrays()

    def build(pkg):
        a = pkg.io.NDArrayIter(x, y, batch_size=5, data_name="da",
                               label_name="la")
        b = pkg.io.NDArrayIter(x[:, 0], y + 1, batch_size=5,
                               data_name="db", label_name="lb")
        return pkg.io.PrefetchingIter(
            [a, b], rename_data=[{"da": "x0"}, {"db": "x1"}],
            rename_label=[{"la": "y0"}, {"lb": "y1"}])

    with tmx.cpu():
        tpf = build(tmx)
    jpf = build(jmx)
    assert _descs(tpf.provide_data) == _descs(jpf.provide_data) == \
        [("x0", (5, 3, 2)), ("x1", (5, 2))]
    assert _descs(tpf.provide_label) == _descs(jpf.provide_label)
    _same_batches(_batches(tpf), _batches(jpf))
    tpf.close()
    jpf.close()


def test_prefetching_iter_sources_of_unequal_length():
    x, y = _arrays()
    with tmx.cpu():
        pf = tmx.io.PrefetchingIter(
            [tmx.io.NDArrayIter(x, y, batch_size=5),
             tmx.io.NDArrayIter(x[:10], y[:10], batch_size=5)])
    with pytest.raises(MXNetError, match="disagree"):
        list(pf)
    pf.close()


# -- ImageRecordIter ---------------------------------------------------------

def write_rec(path, n, label_width=1, seed=0, side=(36, 52), idx=True):
    """``n`` JPEG images (quality 90) with sides in [side[0], side[1]);
    labels of ``label_width`` floats.  Returns the .rec path."""
    rec = str(path) + ".rec"
    rng = np.random.RandomState(seed)
    w = trec.MXIndexedRecordIO(str(path) + ".idx", rec, "w") if idx \
        else trec.MXRecordIO(rec, "w")
    for i in range(n):
        img = rng.randint(0, 256, (rng.randint(*side), rng.randint(*side),
                                   3)).astype(np.uint8)
        label = float(rng.randint(10)) if label_width == 1 else \
            (rng.rand(label_width) * 10).astype(np.float32)
        buf = trec.pack_img((0, label, i, 0), img, quality=90)
        if idx:
            w.write_idx(i, buf)
        else:
            w.write(buf)
    w.close()
    return rec


@pytest.fixture(scope="module")
def rec(tmp_path_factory):
    return write_rec(tmp_path_factory.mktemp("irec") / "t", 21)


@pytest.fixture(scope="module")
def rec2(tmp_path_factory):
    return write_rec(tmp_path_factory.mktemp("irec2") / "t", 21,
                     label_width=2, idx=False)


AUG = dict(shuffle=True, rand_crop=True, rand_mirror=True, seed=5)


@pytest.mark.parametrize("label_width, kw", [
    (1, dict(AUG)),
    (1, dict(AUG, round_batch=False)),
    (1, dict(AUG, num_parts=3, part_index=1)),
    (2, dict(AUG, num_parts=2, part_index=0, resize=40)),
    (2, dict(shuffle=False, prefetch_buffer=2, preprocess_threads=1)),
], ids=["aug", "no_round_batch", "part1of3", "labels2_resize", "plain"])
def test_image_record_iter_uint8_and_labels(rec, rec2, label_width, kw):
    path = rec if label_width == 1 else rec2
    common = dict(path_imgrec=path, data_shape=(3, 32, 32), batch_size=4,
                  label_width=label_width, dtype="uint8", **kw)
    want = _batches(jmx.io.ImageRecordIter(**common), epochs=2)
    tit = tmx.io.ImageRecordIter(ctx=tmx.cpu(), **common)
    assert _descs(tit.provide_label) == _descs(
        jmx.io.ImageRecordIter(**common).provide_label)
    got = _batches(tit, epochs=2)
    _same_batches(got, want)
    assert got[0][0][0].dtype == np.uint8
    tit.close()


def test_image_record_iter_normalized(rec):
    kw = dict(path_imgrec=rec, data_shape=(3, 28, 30), batch_size=8,
              mean_r=123.68, mean_g=116.28, mean_b=103.53, std_r=58.395,
              std_g=57.12, std_b=57.375, scale=1 / 0.9, **AUG)
    want = _batches(jmx.io.ImageRecordIter(**kw), epochs=2)
    got = _batches(tmx.io.ImageRecordIter(ctx=tmx.cpu(), **kw), epochs=2)
    _same_batches(got, want, rel=NORM_REL)
    assert [p for _, _, p in got] == [0, 0, 3] * 2


def test_image_record_iter_epochs_reshuffle(rec):
    it = tmx.io.ImageRecordIter(path_imgrec=rec, data_shape=(3, 32, 32),
                                batch_size=21, ctx=tmx.cpu(), **AUG)
    e1 = next(it).label[0].asnumpy()
    it.reset()
    e2 = next(it).label[0].asnumpy()
    assert sorted(e1) == sorted(e2) and not (e1 == e2).all()
    with pytest.raises(MXNetError):
        tmx.io.ImageRecordIter(path_imgrec=rec, data_shape=(32, 32),
                               batch_size=2, ctx=tmx.cpu())
    with pytest.raises(MXNetError, match="no records"):
        tmx.io.ImageRecordIter(path_imgrec=rec, data_shape=(3, 8, 8),
                               batch_size=2, num_parts=40, part_index=0,
                               ctx=tmx.cpu())


def test_image_record_iter_drops_stale_batches(rec):
    """A batch that reset() or close() left decoding stops at its next
    image instead of decoding the rest of a batch no one reads."""
    it = tmx.io.ImageRecordIter(path_imgrec=rec, data_shape=(3, 32, 32),
                                batch_size=4, ctx=tmx.cpu(), **AUG)
    take = np.arange(4)
    stale = it._epoch
    assert it._load_batch(take, 0, 1, stale) is not None
    it.reset()
    assert it._load_batch(take, 0, 1, stale) is None
    it.close()
    assert it._load_batch(take, 0, 1, stale + 1) is None


@pytest.fixture
def native_built():
    """Skips where the native runtime did not build (decided when a test
    runs, not when the module is collected)."""
    if not tnative.available():
        pytest.skip("the native runtime did not build here: %s"
                    % tnative.load_error())


def _jax_native_loaded(wait_s=120.0):
    """Load the JAX package's runtime, waiting while another test process
    may be building cpp/libmxtpu_runtime.so: mxnet_tpu/native.py runs
    ``make`` under a lock of its own process only, so a load beside a
    build elsewhere can fail once and, as it remembers the failure,
    never try again."""
    import time

    from mxnet_tpu import native as jnative

    deadline = time.monotonic() + wait_s
    while not jnative.available() and time.monotonic() < deadline:
        time.sleep(1.0)
        with jnative._lock:
            jnative._tried = False
    return jnative.available()


def test_native_decoder_against_jax_and_pil(native_built, rec):
    kw = dict(path_imgrec=rec, data_shape=(3, 32, 32), batch_size=5,
              dtype="uint8")
    tit = tmx.io.ImageRecordIter(ctx=tmx.cpu(), **kw)
    assert tit._native_ok
    got = _batches(tit, epochs=2)
    assert tit._decoded["native"] >= 10 and tit._decoded["python"] == 0
    assert _jax_native_loaded()
    jit = jmx.io.ImageRecordIter(**kw)
    assert jit._native_ok
    _same_batches(got, _batches(jit, epochs=2))
    pil = tmx.io.ImageRecordIter(ctx=tmx.cpu(), **kw)
    pil._native_ok = False
    pil.reset()
    ref = _batches(pil)
    assert pil._decoded["python"] >= 5
    for (gd, gl, gp), (rd, rl, rp) in zip(got, ref):
        diff = np.abs(gd[0].astype(int) - rd[0].astype(int))
        assert diff.max() <= NATIVE_LEVELS
        np.testing.assert_array_equal(gl[0], rl[0])
        assert gp == rp


def test_native_refusal_falls_back_and_is_counted(native_built, tmp_path):
    small = write_rec(tmp_path / "s", 6, side=(12, 20))
    it = tmx.io.ImageRecordIter(path_imgrec=small, data_shape=(3, 24, 24),
                                batch_size=3, ctx=tmx.cpu())
    batches = _batches(it)
    assert not it._native_ok
    assert it._decoded["python"] >= 2 and len(batches) == 2
    assert batches[0][0][0].shape == (3, 3, 24, 24)


def test_native_index_reader_and_pool(native_built, rec2):
    positions = tnative.recordio_index(rec2)
    py = trec.MXRecordIO(rec2, "r")
    reader = tnative.RecordReader(rec2)
    for pos in positions:
        py.seek(pos)
        assert reader.read_at(pos) == py.read()
    assert py.read() is None
    reader.close()
    py.close()
    tnative.pool_clear()
    assert tstorage.pool_stats()["bytes_allocated"] == 0
    tmx.io.ImageRecordIter(path_imgrec=rec2, data_shape=(3, 30, 30),
                           batch_size=3, ctx=tmx.cpu())  # no .idx: native
    batch, labels, failed = tnative.decode_batch(rec2, positions[:4], 20,
                                                 20, threads=2)
    assert failed == 0 and batch.shape == (4, 20, 20, 3)
    stats = tstorage.pool_stats()
    assert stats["n_alloc"] >= 1 and stats["n_free"] >= 1
    tstorage.release_all()
    assert tstorage.pool_stats()["bytes_pooled"] == 0
    assert tstorage.available()


def _snapshot(directory):
    return {p.name: (p.stat().st_size, p.stat().st_mtime_ns)
            for p in Path(directory).iterdir()}


_FRESH_BUILD = r"""
from mxnet_tpu_torch import native
assert native.available(), native.load_error()
print("BUILT", native.library_path())
"""


def test_native_library_builds_under_the_port_and_leaves_cpp_alone(
        native_built):
    """A fresh build (another spelling of the compiler names another
    library) lands in mxnet_tpu_torch/_build/ and leaves cpp/ as it
    was."""
    path = tnative.library_path()
    assert path.parent == ROOT / "mxnet_tpu_torch" / "_build"
    assert path.exists() and tnative.load_error() is None
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    env = dict(os.environ, CXX=os.path.join(os.path.dirname(cxx), ".",
                                            os.path.basename(cxx)))
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    before = _snapshot(ROOT / "cpp")
    proc = subprocess.run([sys.executable, "-c", _FRESH_BUILD],
                          cwd=str(ROOT), env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    built = Path(proc.stdout.split("BUILT", 1)[1].strip())
    try:
        assert built.parent == path.parent and built != path
        assert _snapshot(ROOT / "cpp") == before
    finally:
        built.unlink(missing_ok=True)


_BAD_CXX = r"""
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import native, storage
assert not native.available()
err = native.load_error()
assert err and "no-such-compiler" in err, err
assert storage.pool_stats()["n_alloc"] == 0
print("REFUSED", err.splitlines()[0][:200])
"""


def test_a_failing_compiler_leaves_the_reason(tmp_path):
    env = dict(os.environ, CXX=str(tmp_path / "no-such-compiler"))
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _BAD_CXX], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "REFUSED" in proc.stdout
