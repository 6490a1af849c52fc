"""20 Newsgroups loader — port of ``keystone_tpu/loaders/newsgroups.py``
(the reference's ``NewsgroupsDataLoader.scala``): one directory per class
(the reference's fixed class list), one text file per post."""

from __future__ import annotations

import dataclasses
import glob
import os

import numpy as np

# the reference's class order (NewsgroupsDataLoader.classes): label ids
# depend on it
CLASSES = (
    "comp.graphics",
    "comp.os.ms-windows.misc",
    "comp.sys.ibm.pc.hardware",
    "comp.sys.mac.hardware",
    "comp.windows.x",
    "rec.autos",
    "rec.motorcycles",
    "rec.sport.baseball",
    "rec.sport.hockey",
    "sci.crypt",
    "sci.electronics",
    "sci.med",
    "sci.space",
    "misc.forsale",
    "talk.politics.misc",
    "talk.politics.guns",
    "talk.politics.mideast",
    "talk.religion.misc",
    "alt.atheism",
    "soc.religion.christian",
)


@dataclasses.dataclass
class TextData:
    labels: np.ndarray  # (N,) int32
    data: list  # the documents' strings

    def __len__(self):
        return len(self.data)


def load_newsgroups(path: str) -> TextData:
    """Every post under ``path``, which holds one subdirectory per class
    name, in class order and then sorted file order."""
    docs: list[str] = []
    labels: list[int] = []
    for idx, cls in enumerate(CLASSES):
        cls_dir = os.path.join(path, cls)
        if not os.path.isdir(cls_dir):
            continue
        for f in sorted(glob.glob(os.path.join(cls_dir, "*"))):
            if not os.path.isfile(f):
                continue
            with open(f, errors="replace") as fh:
                docs.append(fh.read())
            labels.append(idx)
    if not docs:
        raise FileNotFoundError(f"no newsgroup class directories under {path}")
    return TextData(labels=np.asarray(labels, np.int32), data=docs)
