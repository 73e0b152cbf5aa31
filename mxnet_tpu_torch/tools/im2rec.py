"""im2rec: build RecordIO image datasets, the port's copy of
tools/im2rec.py (the reference's tools/im2rec.py / im2rec.cc).

Two modes, same as the reference:
  --list: walk an image directory and write a .lst file
          (``index\\tlabel\\trelative/path``), labels from subdirectory
          order, optional train/val split.
  (default): pack a .lst + image root into ``prefix.rec`` +
          ``prefix.idx`` (indexed RecordIO), JPEG-encoding each image
          with optional resize/quality — the file format
          ImageRecordIter and the native decoder consume.

Uses PIL instead of OpenCV, as the JAX package's tool does, so both
write the same bytes.

Usage::

    python -m mxnet_tpu_torch.tools.im2rec --list PREFIX ROOT
    python -m mxnet_tpu_torch.tools.im2rec PREFIX ROOT [--resize N]
"""
import argparse
import io
import os
import random
import sys

from mxnet_tpu_torch import recordio

_EXTS = {".jpg", ".jpeg", ".png", ".bmp"}


def make_list(args):
    root = args.root
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    label_of = {c: i for i, c in enumerate(classes)}
    items = []
    if classes:
        for c in classes:
            for dirpath, _dirs, files in os.walk(os.path.join(root, c)):
                for f in sorted(files):
                    if os.path.splitext(f)[1].lower() in _EXTS:
                        rel = os.path.relpath(os.path.join(dirpath, f),
                                              root)
                        items.append((label_of[c], rel))
    else:  # flat directory: label 0
        for f in sorted(os.listdir(root)):
            if os.path.splitext(f)[1].lower() in _EXTS:
                items.append((0, f))
    if args.shuffle:
        random.Random(args.seed).shuffle(items)
    n_train = int(len(items) * args.train_ratio)
    splits = [("", items)] if args.train_ratio >= 1.0 else [
        ("_train", items[:n_train]), ("_val", items[n_train:])]
    for suffix, part in splits:
        path = args.prefix + suffix + ".lst"
        with open(path, "w") as f:
            for i, (lab, rel) in enumerate(part):
                f.write("%d\t%f\t%s\n" % (i, float(lab), rel))
        print("wrote %s (%d items, %d classes)"
              % (path, len(part), max(1, len(classes))))


def _encode(path, args):
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if args.resize > 0:
        w, h = img.size
        scale = args.resize / min(w, h)
        if scale != 1.0:
            img = img.resize((max(1, int(w * scale)),
                              max(1, int(h * scale))),
                             Image.BILINEAR)
    buf = io.BytesIO()
    img.save(buf, format="JPEG", quality=args.quality)
    return buf.getvalue()


def make_rec(args):
    # the prefix must name the .lst (directly or by adding the
    # extension) — guessing further could resolve to a previous run's
    # .rec and truncate it before reading
    lst = args.prefix if args.prefix.endswith(".lst") \
        else args.prefix + ".lst"
    if not os.path.exists(lst):
        raise SystemExit("list file %r not found (generate with --list)"
                         % lst)
    out_prefix = lst[:-len(".lst")]
    writer = recordio.MXIndexedRecordIO(out_prefix + ".idx",
                                        out_prefix + ".rec", "w")
    n = 0
    with open(lst) as f:
        for line in f:
            parts = line.strip().split("\t")
            if len(parts) < 3:
                continue
            # idx \t label [\t label2 ...] \t path — multi-label rows
            # keep every label (recordio.IRHeader supports arrays)
            idx, rel = int(parts[0]), parts[-1]
            labels = [float(x) for x in parts[1:-1]]
            label = labels[0] if len(labels) == 1 else labels
            try:
                payload = _encode(os.path.join(args.root, rel), args)
            except Exception as e:
                print("skipping %s: %s" % (rel, e), file=sys.stderr)
                continue
            header = recordio.IRHeader(0, label, idx, 0)
            writer.write_idx(idx, recordio.pack(header, payload))
            n += 1
            if n % 1000 == 0:
                print("packed %d images" % n)
    writer.close()
    print("wrote %s.rec / %s.idx (%d records)" % (out_prefix, out_prefix,
                                                  n))


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("prefix", help="output prefix (or .lst path when "
                                  "packing)")
    p.add_argument("root", help="image root directory")
    p.add_argument("--list", action="store_true",
                   help="generate the .lst instead of packing a .rec")
    p.add_argument("--shuffle", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--train-ratio", type=float, default=1.0)
    p.add_argument("--resize", type=int, default=0,
                   help="resize shorter side to this many pixels")
    p.add_argument("--quality", type=int, default=95)
    args = p.parse_args(argv)
    if args.list:
        make_list(args)
    else:
        make_rec(args)


if __name__ == "__main__":
    main()
