"""The port's recordio, image and image.detection modules against the JAX
package's on CPU.

- RecordIO: the same records written by both packages give byte-equal
  .rec and .idx files, and each package reads the other's (scalar and
  vector IRHeader labels); pack_img/unpack_img give equal bytes/pixels.
- image.py: each function and augmenter on the same uint8 (or float32)
  input, after the same ``np.random.seed``: integer results equal, float
  results within 1e-5 relative (the colour jitters, LightingAug,
  color_normalize and CreateAugmenter chains).  A crop or flip is an
  array of its own: writing into it leaves the source as it was.
- ImageIter (.rec and imglist), ImageRecordIterPy and ImageDetIter with
  the Det* augmenters (Python's ``random`` seeded alike): batches equal
  (pixels within 1e-5 where a float chain runs), detection labels within
  1e-6.
The port's image arrays are host arrays; ImageIter batches go to the
current context, so the port's side runs inside ``with tmx.cpu():``."""
import os
import random

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import recordio as jrec
from mxnet_tpu.image import detection as jdet
from mxnet_tpu.image import image as jim

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import recordio as trec
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.image import detection as tdet
from mxnet_tpu_torch.image import image as tim

FLOAT_RTOL = 1e-5
DET_ATOL = 1e-6


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _same(got, want, rtol=FLOAT_RTOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, want.shape, got.dtype, want.dtype)
    if got.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol,
                                   atol=rtol * max(1.0, np.abs(want).max()))


def _records():
    """(header, payload) pairs: scalar and vector labels, odd lengths."""
    rng = np.random.RandomState(0)
    out = []
    for i in range(7):
        label = float(i) if i % 2 else rng.rand(i % 3 + 2).astype(
            np.float32)
        out.append((i, (0, label, i, 100 + i),
                    rng.bytes(int(rng.randint(0, 50)))))
    return out


def _write(pkg, root):
    rec, idx = os.path.join(root, "r.rec"), os.path.join(root, "r.idx")
    w = pkg.MXIndexedRecordIO(idx, rec, "w")
    for key, header, payload in _records():
        w.write_idx(key, pkg.pack(header, payload))
    w.close()
    return rec, idx


@pytest.mark.parametrize("writer, reader", [(jrec, trec), (trec, jrec)],
                         ids=["jax_to_port", "port_to_jax"])
def test_rec_and_idx_files_cross_over(tmp_path, writer, reader):
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir(), b.mkdir()
    rec_w, idx_w = _write(writer, str(a))
    rec_r, idx_r = _write(reader, str(b))
    with open(rec_w, "rb") as f1, open(rec_r, "rb") as f2:
        assert f1.read() == f2.read()
    with open(idx_w) as f1, open(idx_r) as f2:
        assert f1.read() == f2.read()
    r = reader.MXIndexedRecordIO(idx_w, rec_w, "r")
    assert r.keys == [k for k, _, _ in _records()]
    for key, (flag, label, id_, id2), payload in _records():
        header, body = reader.unpack(r.read_idx(key))
        assert body == payload and header.id == id_ and header.id2 == id2
        np.testing.assert_array_equal(np.atleast_1d(header.label),
                                      np.atleast_1d(np.float32(label)))
        assert header.flag == (0 if np.isscalar(label) else len(label))
    r.close()
    seq = reader.MXRecordIO(rec_w, "r")
    n = 0
    while seq.read() is not None:
        n += 1
    assert n == len(_records())
    seq.close()


def test_pack_img_unpack_img():
    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, (20, 24, 3)).astype(np.uint8)
    hdr = (0, 3.0, 7, 0)
    for fmt, q in ((".jpg", 90), (".png", 95)):
        tb = trec.pack_img(hdr, img, quality=q, img_fmt=fmt)
        assert tb == jrec.pack_img(hdr, img, quality=q, img_fmt=fmt)
        th, timg = trec.unpack_img(tb)
        jh, jimg = jrec.unpack_img(tb)
        assert tuple(th)[1:] == tuple(jh)[1:] == (3.0, 7, 0)
        np.testing.assert_array_equal(timg, jimg)
        if fmt == ".png":
            np.testing.assert_array_equal(timg, img)
    gray = img[..., :1]
    g = trec.pack_img(hdr, gray, img_fmt=".png")
    np.testing.assert_array_equal(trec.unpack_img(g, 0)[1], gray)


def test_write_through_a_read_handle_raises(tmp_path):
    rec, _ = _write(trec, str(tmp_path))
    r = trec.MXRecordIO(rec, "r")
    with pytest.raises(RuntimeError):
        r.write(b"x")
    r.close()


# -- image.py ----------------------------------------------------------------

def _img(seed=0, shape=(30, 40, 3)):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(
        np.uint8)


def _pair(fn_j, fn_t, make_input, seed=11):
    """fn_j on the JAX array and fn_t on the port's of the same pixels,
    each after np.random.seed(seed)."""
    np.random.seed(seed)
    jout = fn_j(jmx.nd.array(make_input()))
    np.random.seed(seed)
    tout = fn_t(tmx.nd.array(make_input(), ctx=tmx.cpu()))
    return jout, tout


def test_imdecode_imread_imencode(tmp_path):
    img = _img(2)
    buf = jim.imencode(img, quality=90)
    assert tim.imencode(img, quality=90) == buf
    assert tim.imencode(tmx.nd.array(img, ctx=tmx.cpu()), quality=90) == buf
    for flag in (1, 0):
        t = tim.imdecode(buf, flag)
        assert t.context == tmx.cpu()
        _same(t, jim.imdecode(buf, flag))
        _same(tim.imdecode_np(buf, flag), jim.imdecode_np(buf, flag))
    path = tmp_path / "a.jpg"
    path.write_bytes(buf)
    _same(tim.imread(str(path)), jim.imread(str(path)))


@pytest.mark.parametrize("name, args", [
    ("imresize", (17, 23)), ("imresize", (50, 9, 0)),
    ("resize_short", (16,)), ("resize_short", (50, 1)),
    ("fixed_crop", (3, 4, 10, 12)), ("fixed_crop", (3, 4, 10, 12, (8, 6))),
    ("center_crop", ((20, 10),)), ("center_crop", ((50, 50),)),
    ("random_crop", ((20, 10),)), ("random_crop", ((16, 16), 1)),
    ("random_size_crop", ((16, 16), (0.08, 1.0), (0.75, 1.333))),
    ("random_size_crop", ((16, 12), 0.5, (0.5, 2.0))),
    ("copyMakeBorder", (1, 2, 3, 4, 0, 7.0)),
    ("copyMakeBorder", (2, 1, 0, 3, 1)), ("copyMakeBorder", (2, 1, 1, 2, 2)),
    ("copyMakeBorder", (1, 1, 2, 2, 3)), ("copyMakeBorder", (2, 2, 1, 1, 4)),
])
def test_image_function(name, args):
    jout, tout = _pair(lambda x: getattr(jim, name)(x, *args),
                       lambda x: getattr(tim, name)(x, *args), _img)
    if isinstance(jout, tuple):  # (image, window)
        assert tuple(tout[1]) == tuple(int(v) for v in jout[1])
        jout, tout = jout[0], tout[0]
    assert tout.context == tmx.cpu()
    _same(tout, jout)


def test_copy_make_border_rejects_unknown_type():
    with pytest.raises(MXNetError):
        tim.copyMakeBorder(_img(), 1, 1, 1, 1, border_type=9)


@pytest.mark.parametrize("mean, std", [
    (np.array([10.0, 20.0, 30.0], np.float32), None),
    (np.array([10.0, 20.0, 30.0], np.float32),
     np.array([2.0, 3.0, 4.0], np.float32)),
    (5.0, 3.0)])
def test_color_normalize(mean, std):
    def make():
        return _img(3).astype(np.float32)

    jmean = jmx.nd.array(mean) if isinstance(mean, np.ndarray) else mean
    jstd = jmx.nd.array(std) if isinstance(std, np.ndarray) else std
    jout, tout = _pair(lambda x: jim.color_normalize(x, jmean, jstd),
                       lambda x: tim.color_normalize(x, mean, std), make)
    _same(tout, jout)


def test_crops_and_flips_do_not_write_through():
    src = tmx.nd.array(_img(4), ctx=tmx.cpu())
    before = src.asnumpy().copy()
    outs = [tim.fixed_crop(src, 0, 0, 40, 10),
            tim.center_crop(src, (20, 20))[0],
            tim.HorizontalFlipAug(1.0)(src)]
    for out in outs:
        out[:] = 0
    np.testing.assert_array_equal(src.asnumpy(), before)


def _augmenters(pkg):
    im = jim if pkg is jmx else tim
    return [
        ("ResizeAug", im.ResizeAug(20), False),
        ("ForceResizeAug", im.ForceResizeAug((25, 15), 0), False),
        ("RandomCropAug", im.RandomCropAug((20, 16)), False),
        ("CenterCropAug", im.CenterCropAug((21, 13)), False),
        ("HorizontalFlipAug", im.HorizontalFlipAug(0.5), False),
        ("CastAug", im.CastAug(), False),
        ("BrightnessJitterAug", im.BrightnessJitterAug(0.4), True),
        ("ContrastJitterAug", im.ContrastJitterAug(0.4), True),
        ("SaturationJitterAug", im.SaturationJitterAug(0.4), True),
        ("HueJitterAug", im.HueJitterAug(0.3), True),
        ("ColorJitterAug", im.ColorJitterAug(0.3, 0.3, 0.3), True),
        ("LightingAug", im.LightingAug(0.5, im._PCA_EIGVAL,
                                       im._PCA_EIGVEC), True),
        ("RandomGrayAug", im.RandomGrayAug(0.7), True),
        ("RandomOrderAug", im.RandomOrderAug(
            [im.BrightnessJitterAug(0.2), im.HorizontalFlipAug(0.5),
             im.RandomGrayAug(0.5)]), True),
    ]


@pytest.mark.parametrize("i", range(14), ids=[
    n for n, _, _ in _augmenters(tmx)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_augmenter(i, seed):
    name, jaug, as_float = _augmenters(jmx)[i]
    _, taug, _ = _augmenters(tmx)[i]
    assert jaug.dumps() == taug.dumps()

    def make():
        img = _img(seed)
        return img.astype(np.float32) if as_float else img

    jout, tout = _pair(jaug, taug, make, seed=seed)
    _same(tout, jout)


@pytest.mark.parametrize("kw", [
    {}, {"resize": 24, "rand_crop": True, "rand_mirror": True},
    {"rand_resize": True, "mean": True, "std": True},
    {"brightness": 0.2, "contrast": 0.2, "saturation": 0.2, "hue": 0.1,
     "pca_noise": 0.1, "rand_gray": 0.3, "mean": np.array([1.0, 2, 3]),
     "std": np.array([4.0, 5, 6])},
], ids=["plain", "resize_crop_mirror", "rand_resize_norm", "colour"])
def test_create_augmenter_chain(kw):
    jaugs = jim.CreateAugmenter((3, 16, 16), **kw)
    taugs = tim.CreateAugmenter((3, 16, 16), **kw)
    assert [type(a).__name__ for a in taugs] == \
        [type(a).__name__ for a in jaugs]

    def chain(augs):
        def run(x):
            for a in augs:
                x = a(x)
            return x
        return run

    for seed in range(3):
        jout, tout = _pair(chain(jaugs), chain(taugs),
                           lambda: _img(seed, (22, 27, 3)), seed=seed)
        _same(tout, jout)


# -- ImageIter, ImageRecordIterPy --------------------------------------------

def _write_images(path, n, label_width, seed=8):
    rec, idx = str(path) + ".rec", str(path) + ".idx"
    w = trec.MXIndexedRecordIO(idx, rec, "w")
    rng = np.random.RandomState(seed)
    for i in range(n):
        img = rng.randint(0, 256, (rng.randint(20, 30),
                                   rng.randint(20, 30), 3)).astype(np.uint8)
        label = float(i % 4) if label_width == 1 else \
            [float(i), i + 0.5][:label_width]
        w.write_idx(i, trec.pack_img((0, label, i, 0), img, quality=90))
    w.close()
    return rec


@pytest.fixture(scope="module")
def img_rec(tmp_path_factory):
    """11 JPEG images, 20-29 pixels a side, scalar labels."""
    return _write_images(tmp_path_factory.mktemp("imgrec") / "i", 11, 1)


@pytest.fixture(scope="module")
def img_rec2(tmp_path_factory):
    """The same with labels 2 wide."""
    return _write_images(tmp_path_factory.mktemp("imgrec2") / "i", 11, 2)


def _batches(it, n=None):
    out = []
    for k, b in enumerate(it):
        if n is not None and k == n:
            break
        out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
    return out


def _same_batches(tb, jb, rtol=FLOAT_RTOL):
    assert len(tb) == len(jb) > 0
    for (td, tl, tp), (jd, jl, jp) in zip(tb, jb):
        _same(td, jd, rtol)
        _same(tl, jl)
        assert tp == jp


@pytest.mark.parametrize("label_width, kw", [
    (1, {"shuffle": True, "rand_crop": True, "rand_mirror": True}),
    (2, {"num_parts": 2, "part_index": 1, "brightness": 0.3, "mean": True,
         "std": True}),
], ids=["shuffle_crop_mirror", "parts_labels_colour"])
def test_image_iter_over_a_rec(img_rec, img_rec2, label_width, kw):
    rec = img_rec if label_width == 1 else img_rec2

    def build(pkg):
        return pkg.image.ImageIter(4, (3, 16, 16), label_width=label_width,
                                   path_imgrec=rec, **kw)

    np.random.seed(5)
    jb = _batches(build(jmx))
    np.random.seed(5)
    with tmx.cpu():
        tb = _batches(build(tmx))
    _same_batches(tb, jb)


def test_image_iter_over_an_imglist(tmp_path):
    names = []
    for i in range(5):
        p = tmp_path / ("%d.png" % i)
        p.write_bytes(jim.imencode(_img(i, (18, 20, 3)), img_fmt=".png"))
        names.append(p.name)
    imglist = [[float(i), n] for i, n in enumerate(names)]
    lst = tmp_path / "l.lst"
    lst.write_text("".join("%d\t%f\t%s\n" % (i, i * 2.0, n)
                           for i, n in enumerate(names)))
    for kw in ({"imglist": imglist}, {"path_imglist": str(lst)}):
        np.random.seed(2)
        jb = _batches(jmx.image.ImageIter(2, (3, 12, 12), path_root=str(
            tmp_path), rand_crop=True, **kw))
        np.random.seed(2)
        with tmx.cpu():
            it = tmx.image.ImageIter(2, (3, 12, 12), path_root=str(
                tmp_path), rand_crop=True, **kw)
            tb = _batches(it)
        _same_batches(tb, jb)
        assert tb[-1][2] == 1  # 5 images in batches of 2


def test_image_iter_batches_follow_the_current_context(img_rec):
    it = tmx.image.ImageIter(4, (3, 16, 16), path_imgrec=img_rec)
    with tmx.cpu():
        assert next(it).data[0].context == tmx.cpu()


def test_image_record_iter_py(img_rec):
    kw = dict(path_imgrec=img_rec, data_shape=(3, 16, 16), batch_size=4,
              shuffle=True, rand_crop=True, rand_mirror=True, seed=3)
    jb = _batches(jmx.image.ImageRecordIterPy(**kw))
    tb = _batches(tmx.image.ImageRecordIterPy(ctx=tmx.cpu(), **kw))
    _same_batches(tb, jb)


# -- detection ---------------------------------------------------------------

def _det_label(objs):
    flat = [2, 5]
    for o in objs:
        flat.extend(o)
    return np.array(flat, np.float32)


@pytest.fixture(scope="module")
def det_rec(tmp_path_factory):
    root = tmp_path_factory.mktemp("detrec")
    rec, idx = str(root / "d.rec"), str(root / "d.idx")
    w = trec.MXIndexedRecordIO(idx, rec, "w")
    rng = np.random.RandomState(5)
    for i in range(10):
        img = np.full((48, 56, 3), 90, np.uint8)
        x1, y1 = rng.randint(2, 20, 2)
        img[y1:y1 + 16, x1:x1 + 16] = (255, 0, 0)
        objs = [[0, x1 / 56, y1 / 48, (x1 + 16) / 56, (y1 + 16) / 48]]
        if i % 2 == 0:
            img[30:46, 36:52] = (0, 0, 255)
            objs.append([1, 36 / 56, 30 / 48, 52 / 56, 46 / 48])
        w.write_idx(i, trec.pack_img((0, _det_label(objs), i, 0), img,
                                     img_fmt=".png"))
    w.close()
    return rec


def _det_augs(pkg):
    det = jdet if pkg is jmx else tdet
    im = jim if pkg is jmx else tim
    return [
        det.DetHorizontalFlipAug(0.5),
        det.DetRandomCropAug(min_object_covered=0.3),
        det.DetRandomPadAug(area_range=(1.0, 2.0)),
        det.DetBorrowAug(im.BrightnessJitterAug(0.3)),
        det.CreateMultiRandCropAugmenter(
            min_object_covered=[0.1, 0.5], area_range=(0.2, 1.0)),
        det.DetRandomSelectAug([det.DetHorizontalFlipAug(1.0),
                                det.DetRandomPadAug()], skip_prob=0.3),
    ]


@pytest.mark.parametrize("i", range(6), ids=[
    "flip", "crop", "pad", "borrow", "multi_crop", "select"])
def test_det_augmenter(i):
    img = np.full((40, 50, 3), 60, np.uint8)
    img[5:25, 10:30] = 200
    label = np.array([[0, 0.2, 0.125, 0.6, 0.625],
                      [1, 0.5, 0.5, 0.9, 0.95]], np.float32)
    for seed in range(4):
        random.seed(seed)
        np.random.seed(seed)
        jimg, jlab = _det_augs(jmx)[i](jmx.nd.array(img), label.copy())
        random.seed(seed)
        np.random.seed(seed)
        timg, tlab = _det_augs(tmx)[i](tmx.nd.array(img, ctx=tmx.cpu()),
                                       label.copy())
        _same(timg, jimg)
        np.testing.assert_allclose(tlab, jlab, rtol=0, atol=DET_ATOL)


@pytest.mark.parametrize("kw", [
    {"rand_crop": 0.5, "rand_pad": 0.5, "rand_mirror": True},
    {"rand_crop": 1.0, "brightness": 0.2, "contrast": 0.2, "hue": 0.1,
     "pca_noise": 0.1, "rand_gray": 0.2, "mean": True, "std": True},
], ids=["geometry", "colour"])
def test_image_det_iter(det_rec, kw):
    def run(pkg):
        random.seed(7)
        np.random.seed(7)
        it = pkg.image.ImageDetIter(3, (3, 32, 32), path_imgrec=det_rec,
                                    shuffle=True, **kw)
        out = [(it.label_shape, it.provide_label[0].shape)]
        for b in it:
            out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
        return out

    jout = run(jmx)
    with tmx.cpu():
        tout = run(tmx)
    assert tout[0] == jout[0]
    assert len(tout) == len(jout) > 1
    for (td, tl, tp), (jd, jl, jp) in zip(tout[1:], jout[1:]):
        _same(td, jd)
        np.testing.assert_allclose(tl, jl, rtol=0, atol=DET_ATOL)
        assert tp == jp


def test_det_iter_label_shape_tools(det_rec):
    with tmx.cpu():
        a = tmx.image.ImageDetIter(2, (3, 24, 24), path_imgrec=det_rec)
        b = tmx.image.ImageDetIter(2, (3, 24, 24), path_imgrec=det_rec)
    ja = jmx.image.ImageDetIter(2, (3, 24, 24), path_imgrec=det_rec)
    assert a.label_shape == ja.label_shape == (2, 5)
    a.reshape(label_shape=(4, 5))
    assert a.sync_label_shape(b) is b and b.label_shape == (4, 5)
    with pytest.raises(MXNetError):
        a.check_label_shape((1, 5))
    with pytest.raises(MXNetError):
        a.sync_label_shape(object())
    random.seed(1)
    jcanvas = next(ja.draw_next())
    random.seed(1)
    tcanvas = next(tmx.image.ImageDetIter(
        2, (3, 24, 24), path_imgrec=det_rec).draw_next())
    np.testing.assert_array_equal(tcanvas, jcanvas)
