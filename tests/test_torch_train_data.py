"""The port's training data pipeline against the JAX package's on the CPU:
the same indexed corpus (written by the port's ``make_builder``) and the
same seed through both BERT tasks give IDENTICAL batches — tokenization,
masking, padding, the per-epoch shuffle and the batching — over two
epochs.  Plus the port's pure-Python WordPiece against
``tokenizers.BertWordPieceTokenizer`` (which the JAX package uses).
"""

import os
from argparse import Namespace

import numpy as np
import pytest

from unicore_tpu.tasks.bert import BertTask as JaxBertTask

from unicore_tpu_torch.data import BertWordPieceTokenizer, make_builder
from unicore_tpu_torch.data.iterators import GroupedIterator
from unicore_tpu_torch.tasks.bert import BertTask as PortBertTask

WORDS = ["the", "cat", "sat", "on", "mat", "run", "un", "able", "molecule",
         "protein", "energy", "bond"]
VOCAB = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS
         + ["##s", "##ing", "##ed", "##able", ",", ".", "!"])


def write_corpus(path, n_docs=23, seed=0):
    rng = np.random.RandomState(seed)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "dict.txt"), "w") as f:
        f.write("\n".join(VOCAB) + "\n")
    builder = make_builder(os.path.join(path, "train"))
    pieces = WORDS + ["cats", "running", "unable", "zebra", "Mat,", "bond!", "<unk>"]
    for _ in range(n_docs):
        builder.add_item(" ".join(rng.choice(pieces, size=rng.randint(5, 70))))
    builder.finalize()


def task_args(data, **kw):
    args = Namespace(data=data, seed=3, max_seq_len=48, mask_prob=0.15,
                     leave_unmasked_prob=0.1, random_token_prob=0.1,
                     seq_pad_multiple=8, length_bucket=0, train_subset="train")
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def batches(task, epochs, batch_size, update_freq):
    task.load_dataset("train")
    out = []
    for epoch in range(1, epochs + 1):
        itr = task.get_batch_iterator(task.dataset("train"), batch_size=batch_size,
                                      seed=task.args.seed, epoch=epoch)
        grouped = GroupedIterator(itr.next_epoch_itr(shuffle=True), update_freq)
        for group in grouped:
            out.extend(group)
    return out


@pytest.mark.parametrize("pad_multiple", [8, 128])
def test_batches_identical_to_jax(tmp_path, pad_multiple):
    pytest.importorskip("tokenizers")
    data = str(tmp_path / "corpus")
    write_corpus(data)
    jax_task = JaxBertTask.setup_task(task_args(data, seq_pad_multiple=pad_multiple))
    port_task = PortBertTask.setup_task(task_args(data, seq_pad_multiple=pad_multiple))
    assert jax_task.mask_idx == port_task.mask_idx
    got = batches(port_task, epochs=2, batch_size=4, update_freq=2)
    ref = batches(jax_task, epochs=2, batch_size=4, update_freq=2)
    assert len(got) == len(ref) == 12  # 6 batches per epoch, 2 epochs
    for g, r in zip(got, ref):
        for key in ("src_tokens",):
            np.testing.assert_array_equal(g["net_input"][key], r["net_input"][key])
        np.testing.assert_array_equal(g["target"], r["target"])
        assert g["target"].shape[1] % pad_multiple == 0
    # the two epochs differ (reshuffle + epoch-keyed masking)
    assert not all(np.array_equal(a["target"], b["target"])
                   for a, b in zip(got[:6], got[6:]))


WORDPIECE_TEXTS = [
    "The cats sat on the mat!", "Hello, World.", "running unable xyz",
    "Café  naïve résumé", "中文 中", "[UNK] the[MASK]cat [SEP]",
    "tab\there\nnewline\r", "a" * 150, "", "   ", "The cat​sat",
    "cats,,!!mat", "the [UNK] cat", "ÉNERGY Bond's un-able", "\x00�cat",
    "moĺecule", "protein　energy",
]


def test_wordpiece_matches_tokenizers(tmp_path):
    tokenizers = pytest.importorskip("tokenizers")
    vocab = VOCAB + ["hello", "world", "cafe", "naive", "中", "'", "-", "x"]
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(vocab) + "\n")
    ref = tokenizers.BertWordPieceTokenizer(str(path), lowercase=True)
    port = BertWordPieceTokenizer(str(path))
    for text in WORDPIECE_TEXTS:
        assert port.encode_ids(text) == ref.encode(text).ids, text
