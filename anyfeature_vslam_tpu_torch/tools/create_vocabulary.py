"""Offline vocabulary training, counterpart of the reference's
createVocabulary.py + src/createVocabulary.cpp (samples a sequence's frames,
extracts descriptors per feature type, trains a k-means tree with tf-idf
weights, and writes the vocabulary file). Port of tools/create_vocabulary.py:
the port's extractor of the family on `device` (K1 on every pyramid level
of every sampled frame for the FAST families on the card), then the host
k-means of ``place_recognition/vocab.train_vocabulary``; the file is the
JAX package's ``.npz`` format, which either package's ``Vocabulary.load``
reads.

Usage:
    python -m anyfeature_vslam_tpu_torch.tools.create_vocabulary \\
        sequence_path:/path/to/seq feature:orb32 out:/path/voc_orb32.npz \\
        sample_every:6 branching:32 depth:2 max_frames:200 device:cuda

Defaults mirror the reference tool's sampling (every 6th frame,
createVocabulary.py:37-42); branching/depth default to the dense-scoring
shape discussed in place_recognition/vocab.py. ``device:cpu`` runs the
extraction on the CPU.
"""

from __future__ import annotations

import sys

from ..run_mono import parse_args


def extract_descriptors(paths, cfg, device, log=print):
    """The valid descriptor rows of each image in `paths` through the
    port's extractor of `cfg` on `device` (one extractor per image shape),
    as a list of numpy arrays."""
    import torch

    from ..frontend.extractor import make_extractor
    from ..io import dataset

    extractors, out = {}, []
    with torch.no_grad():
        for i, p in enumerate(paths):
            img = dataset.load_gray(p)
            if img.shape not in extractors:
                extractors[img.shape] = make_extractor(cfg, *img.shape).to(device)
            feats = extractors[img.shape](torch.from_numpy(img).to(device))
            v = feats["valid"].cpu().numpy()
            out.append(feats["desc_bits"].cpu().numpy()[v])
            log(f"[{i + 1}/{len(paths)}] {p}: {int(v.sum())} descriptors", flush=True)
    return out


def main(argv=None):
    args = parse_args(argv if argv is not None else sys.argv[1:])
    seq_path = args.get("sequence_path")
    if not seq_path:
        print(__doc__)
        return 1

    import numpy as np
    import torch

    from ..frontend.extractor import ExtractorConfig
    from ..io import dataset
    from ..place_recognition import vocab as vocab_mod

    feature = args.get("feature", "orb32")
    every = int(args.get("sample_every", 6))
    branching = int(args.get("branching", 32))
    depth = int(args.get("depth", 2))
    max_frames = int(args.get("max_frames", 200))
    out = args.get("out", f"voc_{feature}.npz")
    device = torch.device(args.get("device", "cuda"))

    # `sequence_path` accepts a comma-separated list (the reference trains
    # on BOVISA; here multiple rendered sequences diversify the corpus)
    cfg = ExtractorConfig.for_feature(feature, n_features=int(args.get("n_features", 1000)))
    descs = []
    for sp in seq_path.split(","):
        seq = dataset.load_sequence(sp)
        descs += extract_descriptors(seq.image_paths[::every][:max_frames], cfg, device)
    descs = np.concatenate(descs)
    print(f"training vocabulary on {len(descs)} descriptors "
          f"(branching={branching}, depth={depth})", flush=True)
    voc = vocab_mod.train_vocabulary(
        descs, branching=branching, depth=depth,
        iters=int(args.get("iters", 8)),
        max_train=int(args.get("max_train", 50000)),
    )
    voc.save(out)
    print(f"saved {out} ({voc.n_words} words)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
