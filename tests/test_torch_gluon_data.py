"""The port's gluon.data (datasets, samplers, DataLoader, vision datasets
and transforms) and io.DevicePrefetcher against the JAX package's on CPU.

- Dataset views (transform, transform_first, filter, shard, take),
  SimpleDataset, ArrayDataset and RecordFileDataset: items equal; the
  last also under 8 worker threads (a stress run).
- SequentialSampler, RandomSampler (np.random seeded alike) and
  BatchSampler under keep, discard and rollover over two epochs: the
  same index lists and lengths.
- DataLoader with num_workers 0 and 2, with shuffle, with pin_memory and
  a custom batchify: batches equal to the JAX loader's; the port's are
  host arrays.
- MNIST, FashionMNIST (idx files, plain and gzip), CIFAR10/100 (binary
  batches), ImageFolderDataset (PNG folders), ImageRecordDataset (.rec)
  and the synthetic stand-ins: items equal.
- Each transform against the JAX transform after the same np.random.seed:
  integer results equal, float within 1e-5 relative.
- DevicePrefetcher with put=, with trainer= (the port's one-card
  ShardedTrainer.shard_batch on the CPU), with depth 0, and
  DataLoader(device_prefetch=2): the loader's batches, in order, and no
  producer thread left after a break."""
import gzip
import struct
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.gluon import data as jdata
from mxnet_tpu.gluon.data.vision import transforms as jtf

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import parallel as tparallel
from mxnet_tpu_torch import recordio as trec
from mxnet_tpu_torch.gluon import data as tdata
from mxnet_tpu_torch.gluon.data.vision import transforms as ttf
from mxnet_tpu_torch.io import DevicePrefetcher

FLOAT_RTOL = 1e-5


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    return np.asarray(x)


def _same(got, want, rtol=FLOAT_RTOL):
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w, rtol)
        return
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    if got.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol,
                                   atol=rtol * max(1.0, np.abs(want).max()))


def _arrays(n=11):
    rng = np.random.RandomState(0)
    return (rng.rand(n, 3).astype(np.float32),
            rng.randint(0, 4, n).astype(np.int32))


# -- datasets and samplers ----------------------------------------------------

def _views(pkg):
    x, y = _arrays()
    ds = pkg.gluon.data.ArrayDataset(x, y)
    return {
        "array": ds,
        "simple": pkg.gluon.data.SimpleDataset(list(range(7))),
        "single": pkg.gluon.data.ArrayDataset(x),
        "transform": ds.transform(lambda a, b: (a * 2, b + 1)),
        "transform_eager": ds.transform(lambda a, b: (a - 1, b), lazy=False),
        "transform_first": ds.transform_first(lambda a: a.sum()),
        "filter": ds.filter(lambda item: item[1] % 2 == 0),
        "shard": ds.shard(3, 1),
        "take": ds.take(4),
    }


@pytest.mark.parametrize("name", list(_views(tmx)))
def test_dataset_views(name):
    t, j = _views(tmx)[name], _views(jmx)[name]
    assert len(t) == len(j)
    for i in range(len(j)):
        _same(t[i], j[i])


def test_dataset_errors():
    x, y = _arrays()
    with pytest.raises(ValueError):
        tdata.ArrayDataset(x, y[:3])
    with pytest.raises(ValueError):
        tdata.ArrayDataset(x).shard(2, 2)


def _write_rec(path, n=9, fmt=".png", vectors=True):
    """``n`` images; every fourth label a vector when ``vectors``."""
    rng = np.random.RandomState(4)
    w = trec.MXIndexedRecordIO(str(path) + ".idx", str(path) + ".rec", "w")
    for i in range(n):
        img = rng.randint(0, 256, (10 + i, 12, 3)).astype(np.uint8)
        label = float(i % 3) if i % 4 or not vectors else [float(i), 0.5]
        w.write_idx(i, trec.pack_img((0, label, i, 0), img, img_fmt=fmt))
    w.close()
    return str(path) + ".rec"


def test_record_file_dataset(tmp_path):
    rec = _write_rec(tmp_path / "r")
    t, j = tdata.RecordFileDataset(rec), jdata.RecordFileDataset(rec)
    assert len(t) == len(j) == 9
    assert [t[i] for i in range(9)] == [j[i] for i in range(9)]


def test_record_file_dataset_under_concurrent_workers(tmp_path):
    """Worker threads share the dataset's file handle: each read must get
    its own record.  Records of noise JPEGs past the file buffer's 8 KB
    (a read releases the GIL between another thread's seek and read),
    decoded in the workers, under a short switch interval: without the
    dataset's lock this fails in every run (the JAX package's dataset
    shares the handle unguarded)."""
    import sys

    rng = np.random.RandomState(12)
    path = str(tmp_path / "r")
    w = trec.MXIndexedRecordIO(path + ".idx", path + ".rec", "w")
    for i in range(48):
        img = rng.randint(0, 256, (96, 96, 3)).astype(np.uint8)
        w.write_idx(i, trec.pack_img((0, float(i), i, 0), img, quality=95))
    w.close()
    ds = tdata.RecordFileDataset(path + ".rec").transform(
        lambda rec: trec.unpack_img(rec)[0].label)
    want = np.arange(48, dtype=np.float32)
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(20):
            loader = tdata.DataLoader(ds, batch_size=1, num_workers=8)
            got = np.concatenate([b.asnumpy() for b in loader])
            np.testing.assert_array_equal(got, want)
    finally:
        sys.setswitchinterval(before)


@pytest.mark.parametrize("policy", ["keep", "discard", "rollover"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_batch_sampler(policy, shuffle):
    def run(pkg):
        s = pkg.gluon.data.RandomSampler(10) if shuffle else \
            pkg.gluon.data.SequentialSampler(10)
        b = pkg.gluon.data.BatchSampler(s, 3, policy)
        np.random.seed(3)
        out = []
        for _ in range(2):
            out.append((len(b), [list(v) for v in b]))
        return out, len(s), list(s) if not shuffle else None

    assert run(tmx) == run(jmx)
    with pytest.raises(ValueError):
        tdata.BatchSampler(tdata.SequentialSampler(3), 2, "bogus")


# -- DataLoader --------------------------------------------------------------

def _loader_batches(pkg, **kw):
    x, y = _arrays(13)
    ds = pkg.gluon.data.ArrayDataset(x, y)
    np.random.seed(8)
    return [_np(b) for b in pkg.gluon.data.DataLoader(ds, batch_size=4,
                                                      **kw)]


@pytest.mark.parametrize("kw", [
    {}, {"num_workers": 2}, {"shuffle": True, "num_workers": 2},
    {"last_batch": "discard"}, {"pin_memory": True},
    {"num_workers": 2, "pin_memory": True, "prefetch": 1},
], ids=["serial", "workers", "shuffle", "discard", "pin", "workers_pin"])
def test_data_loader(kw):
    _same(_loader_batches(tmx, **kw), _loader_batches(jmx, **kw))


def test_data_loader_batches_are_host_arrays_and_options_checked():
    x, y = _arrays()
    loader = tdata.DataLoader(tdata.ArrayDataset(x, y), batch_size=5,
                              pin_memory=True)
    assert len(loader) == 3
    xb, yb = next(iter(loader))
    assert xb.context == yb.context == tmx.cpu()
    nd_ds = tdata.SimpleDataset([tmx.nd.array(r, ctx=tmx.cpu()) for r in x])
    jnd = jdata.SimpleDataset([jmx.nd.array(r) for r in x])
    _same([b for b in tdata.DataLoader(nd_ds, batch_size=4)],
          [b for b in jdata.DataLoader(jnd, batch_size=4)])
    with pytest.raises(ValueError):
        tdata.DataLoader(nd_ds)
    with pytest.raises(ValueError):
        tdata.DataLoader(nd_ds, batch_size=2, shuffle=True,
                         sampler=tdata.SequentialSampler(2))
    with pytest.raises(ValueError):
        next(iter(tdata.DataLoader(nd_ds, batch_size=2,
                                   device_prefetch="x")))
    custom = tdata.DataLoader(tdata.ArrayDataset(x, y), batch_size=4,
                              batchify_fn=lambda s: len(s))
    assert list(custom) == [4, 4, 3]


# -- vision datasets ---------------------------------------------------------

def _write_mnist(root, train, compress, n=12):
    rng = np.random.RandomState(5 if train else 6)
    imgs = rng.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, n).astype(np.uint8)
    names = ("train-images-idx3-ubyte", "train-labels-idx1-ubyte") \
        if train else ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")
    opener, ext = (gzip.open, ".gz") if compress else (open, "")
    with opener(str(root / (names[0] + ext)), "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + imgs.tobytes())
    with opener(str(root / (names[1] + ext)), "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())


def _write_cifar(root, train, n=6):
    rng = np.random.RandomState(7)
    files = ["data_batch_%d.bin" % i for i in range(1, 6)] if train \
        else ["test_batch.bin"]
    sub = root / "cifar-10-batches-bin"
    sub.mkdir()
    for name in files:
        rows = np.concatenate([rng.randint(0, 10, (n, 1)),
                               rng.randint(0, 256, (n, 3072))], axis=1)
        (sub / name).write_bytes(rows.astype(np.uint8).tobytes())


def _items(ds, n=None):
    n = len(ds) if n is None else n
    return [ds[i] for i in range(0, len(ds), max(1, len(ds) // n))]


@pytest.mark.parametrize("name", ["MNIST", "FashionMNIST"])
@pytest.mark.parametrize("train, compress", [(True, False), (False, True)])
def test_mnist_datasets(tmp_path, name, train, compress):
    _write_mnist(tmp_path, train, compress)
    t = getattr(tdata.vision, name)(root=str(tmp_path), train=train)
    j = getattr(jdata.vision, name)(root=str(tmp_path), train=train)
    assert len(t) == len(j) == 12
    _same(_items(t), _items(j))
    assert t[0][0].context == tmx.cpu()


@pytest.mark.parametrize("name", ["CIFAR10", "CIFAR100"])
def test_cifar_datasets(tmp_path, name):
    for train in (True, False):
        root = tmp_path / str(train)
        root.mkdir()
        _write_cifar(root, train)
        t = getattr(tdata.vision, name)(root=str(root), train=train)
        j = getattr(jdata.vision, name)(root=str(root), train=train)
        assert len(t) == len(j)
        _same(_items(t), _items(j))


@pytest.mark.parametrize("name", ["MNIST", "CIFAR10"])
def test_synthetic_stand_ins(tmp_path, name):
    t = getattr(tdata.vision, name)(root=str(tmp_path / "t"), train=False)
    j = getattr(jdata.vision, name)(root=str(tmp_path / "j"), train=False)
    assert len(t) == len(j) == 8192
    _same(_items(t, 16), _items(j, 16))
    with pytest.raises(tmx.base.MXNetError):
        getattr(tdata.vision, name)(root=str(tmp_path / "n"),
                                    synthetic=False)
    _same(_items(tdata.vision.SyntheticImageDataset(300, (8, 8, 3), 10), 9),
          _items(jdata.vision.SyntheticImageDataset(300, (8, 8, 3), 10), 9))


def test_image_folder_and_record_datasets(tmp_path):
    rng = np.random.RandomState(9)
    for cls in ("cat", "dog"):
        (tmp_path / "f" / cls).mkdir(parents=True)
        for i in range(3):
            img = rng.randint(0, 256, (9, 11, 3)).astype(np.uint8)
            (tmp_path / "f" / cls / ("%d.png" % i)).write_bytes(
                jmx.image.imencode(img, img_fmt=".png"))
        (tmp_path / "f" / cls / "notes.txt").write_text("skip me")
    t = tdata.vision.ImageFolderDataset(str(tmp_path / "f"))
    j = jdata.vision.ImageFolderDataset(str(tmp_path / "f"))
    assert t.synsets == j.synsets == ["cat", "dog"] and len(t) == 6
    _same(_items(t), _items(j))
    rec = _write_rec(tmp_path / "r", fmt=".jpg")
    for flag in (1, 0):
        t = tdata.vision.ImageRecordDataset(rec, flag=flag)
        j = jdata.vision.ImageRecordDataset(rec, flag=flag)
        for i in range(len(j)):
            (ti, tl), (ji, jl) = t[i], j[i]
            _same(ti, ji)
            _same(np.asarray(tl, np.float32), np.asarray(jl, np.float32))
    tt = tdata.vision.ImageRecordDataset(rec, transform=lambda d, l: d.shape)
    assert tt[2] == (12, 12, 3)


# -- transforms --------------------------------------------------------------

def _transforms(pkg):
    tf = jtf if pkg is jmx else ttf
    return {
        "Cast": (tf.Cast("float16"), "u8"),
        "ToTensor": (tf.ToTensor(), "u8"),
        "ToTensor_batch": (tf.ToTensor(), "u8_batch"),
        "Normalize": (tf.Normalize([0.4, 0.5, 0.6], [0.2, 0.25, 0.3]),
                      "chw"),
        "Resize": (tf.Resize((13, 9)), "u8"),
        "CenterCrop": (tf.CenterCrop(10), "u8"),
        "RandomCrop": (tf.RandomCrop((12, 8)), "u8"),
        "RandomResizedCrop": (tf.RandomResizedCrop(10), "u8"),
        "RandomFlipLeftRight": (tf.RandomFlipLeftRight(), "u8"),
        "RandomFlipTopBottom": (tf.RandomFlipTopBottom(), "u8"),
        "RandomBrightness": (tf.RandomBrightness(0.3), "hwc"),
        "RandomContrast": (tf.RandomContrast(0.3), "hwc"),
        "RandomSaturation": (tf.RandomSaturation(0.3), "hwc"),
        "RandomHue": (tf.RandomHue(0.2), "hwc"),
        "RandomColorJitter": (tf.RandomColorJitter(0.2, 0.2, 0.2, 0.1),
                              "hwc"),
        "RandomLighting": (tf.RandomLighting(0.1), "hwc"),
        "Compose": (tf.Compose([tf.RandomResizedCrop(12),
                                tf.RandomFlipLeftRight(), tf.ToTensor(),
                                tf.Normalize(0.5, 0.25),
                                tf.Cast("float32")]), "u8"),
    }


def _input(kind, seed):
    rng = np.random.RandomState(seed)
    if kind == "u8":
        return rng.randint(0, 256, (20, 17, 3)).astype(np.uint8)
    if kind == "u8_batch":
        return rng.randint(0, 256, (2, 6, 5, 3)).astype(np.uint8)
    if kind == "chw":
        return rng.rand(3, 6, 5).astype(np.float32)
    return rng.rand(9, 7, 3).astype(np.float32)


@pytest.mark.parametrize("name", list(_transforms(tmx)))
def test_transform(name):
    tblock, kind = _transforms(tmx)[name]
    jblock, _ = _transforms(jmx)[name]
    for seed in range(4):
        x = _input(kind, seed)
        np.random.seed(seed)
        want = jblock(jmx.nd.array(x))
        np.random.seed(seed)
        got = tblock(tmx.nd.array(x, ctx=tmx.cpu()))
        assert got.context == tmx.cpu()
        _same(got, want)


def test_transform_first_through_a_loader(tmp_path):
    rec = _write_rec(tmp_path / "r", n=8, fmt=".jpg", vectors=False)
    chain = [ttf.CenterCrop(8), ttf.ToTensor()], [jtf.CenterCrop(8),
                                                  jtf.ToTensor()]
    t = tdata.vision.ImageRecordDataset(rec).transform_first(
        ttf.Compose(chain[0]))
    j = jdata.vision.ImageRecordDataset(rec).transform_first(
        jtf.Compose(chain[1]))
    _same([_np(b) for b in tdata.DataLoader(t, batch_size=3,
                                            num_workers=2)],
          [_np(b) for b in jdata.DataLoader(j, batch_size=3)])


# -- DevicePrefetcher --------------------------------------------------------

def _prefetch_threads():
    return [th for th in threading.enumerate()
            if th.name == "mxnet_tpu_torch-device-prefetch"]


def _wait_no_prefetch_thread():
    deadline = time.monotonic() + 10
    while _prefetch_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    return not _prefetch_threads()


def _loader():
    x, y = _arrays(23)
    return tdata.DataLoader(tdata.ArrayDataset(x, y), batch_size=4)


def _values(batches):
    return [[_np(v) for v in b] for b in batches]


def test_device_prefetcher_put_and_depths():
    want = _values(_loader())

    def put(batch):
        return [v._data.clone() for v in batch]

    for depth in (0, 1, 3):
        with DevicePrefetcher(_loader(), put=put, depth=depth) as pf:
            got = [[v.numpy() for v in b] for b in pf]
        _same(got, want)
    with tmx.cpu():
        got = list(DevicePrefetcher(_loader(), depth=2))
    assert all(isinstance(v, torch.Tensor) for b in got for v in b)
    _same([[v.numpy() for v in b] for b in got], want)
    assert _wait_no_prefetch_thread()


def test_device_prefetcher_through_the_sharded_trainer():
    net = tmx.gluon.nn.Dense(4)
    net.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
    net(tmx.nd.zeros((1, 3), ctx=tmx.cpu()))
    trainer = tparallel.ShardedTrainer(
        net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), optimizer="sgd",
        optimizer_params={"learning_rate": 0.1})
    x = np.ones((2, 3), np.float32)
    xs, ys = trainer.shard_batch(tmx.nd.array(x, ctx=tmx.cpu()), x[:, 0])
    assert xs.device.type == ys.device.type == "cpu"
    np.testing.assert_array_equal(xs.numpy(), x)
    want = _values(_loader())
    losses = []
    with DevicePrefetcher(_loader(), trainer=trainer, depth=2) as pf:
        got = []
        for xb, yb in pf:
            got.append([xb.numpy(), yb.numpy()])
            losses.append(float(trainer.step([xb], yb.float())))
    _same(got, want)
    assert np.isfinite(losses).all() and len(losses) == 6
    single = list(DevicePrefetcher([tmx.nd.array(x, ctx=tmx.cpu())],
                                   trainer=trainer, depth=1))
    np.testing.assert_array_equal(single[0].numpy(), x)


def test_data_loader_device_prefetch_stops_its_thread_on_break():
    want = _values(_loader())
    x, y = _arrays(23)
    loader = tdata.DataLoader(tdata.ArrayDataset(x, y), batch_size=4,
                              num_workers=2, device_prefetch=2)
    with tmx.cpu():
        got = [[v.numpy() for v in b] for b in loader]
    _same(got, want)
    assert _wait_no_prefetch_thread()
    with tmx.cpu():
        it = iter(loader)
        first = next(it)
        assert len(_prefetch_threads()) == 1
        del it
    assert _wait_no_prefetch_thread()
    np.testing.assert_array_equal(first[0].numpy(), want[0][0])


def test_device_prefetcher_surfaces_source_errors_in_order():
    def source():
        yield [np.zeros(2, np.float32)]
        raise RuntimeError("boom")

    pf = DevicePrefetcher(source(), put=lambda b: b, depth=2)
    assert next(pf)[0].shape == (2,)
    with pytest.raises(RuntimeError, match="boom"):
        next(pf)
    with pytest.raises(StopIteration):
        next(pf)
    pf.close()
    assert _wait_no_prefetch_thread()


def test_device_prefetcher_defaults_to_the_card():
    if torch.cuda.is_available():
        got = list(DevicePrefetcher(_loader()))
        assert all(v.is_cuda for b in got for v in b)
    else:
        with pytest.raises(tmx.base.MXNetError,
                           match="CUDA is not available"):
            DevicePrefetcher(_loader())
