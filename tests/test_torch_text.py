"""Port parity: the port's copies of the text codec and HParams against the
JAX package's."""

import dataclasses

import pytest

from gantron_tpu import text as jax_text
from gantron_tpu.config import ClassifierHParams as JaxClassifierHParams
from gantron_tpu.config import HParams as JaxHParams
from gantron_tpu_torch import text as port_text
from gantron_tpu_torch.config import ClassifierHParams, HParams
from torch_threads import one_torch_thread  # noqa: F401

SENTENCES = [
    "This voice was generated by a machine, measuring end to end synthesis "
    "speed.",
    "Dr. Smith paid $3.50 for 2 apples on Jan. 1st, 1999 at 10:30.",
    "Mr. and Mrs. Jones met Capt. Lee at St. Mary's, Ltd. no. 42!",
    "Café naïve façade — “smart quotes” and Ærøskøbing.",
    "Turn {HH AW1 S} lights on at {S T AA1 R T} time.",
    "It cost £1,234,567.89, or 12% of 100,000th of a 3rd.",
    "",
]


@pytest.mark.parametrize("text", SENTENCES)
@pytest.mark.parametrize("cleaners", [["english_cleaners"],
                                      ["basic_cleaners"],
                                      ["transliteration_cleaners"]])
def test_text_to_sequence_matches_jax(text, cleaners):
    seq = port_text.text_to_sequence(text, cleaners)
    assert seq == jax_text.text_to_sequence(text, cleaners)
    assert port_text.sequence_to_text(seq) == jax_text.sequence_to_text(seq)


def test_unknown_cleaner_raises():
    with pytest.raises(ValueError):
        port_text.text_to_sequence("a", ["no_such_cleaner"])


def test_hparams_defaults_match_jax():
    port, ref = HParams(), JaxHParams()
    names = [f.name for f in dataclasses.fields(HParams)]
    assert names == [f.name for f in dataclasses.fields(JaxHParams)]
    for name in names:
        assert getattr(port, name) == getattr(ref, name), name


@pytest.mark.parametrize("overrides", [
    "use_noise=True,use_labels=False,quantized_inference=True",
    "fp16_run=True,mel_buckets=[240,480],training_files=[/a.txt,/b.txt]",
    "n_frames_per_step=2,gate_threshold=0.3,vesus_path=/data/vesus",
])
def test_hparams_overrides_match_jax(overrides):
    assert HParams.create(overrides).as_dict() == \
        JaxHParams.create(overrides).as_dict()


@pytest.mark.parametrize("overrides", [
    None,
    "use_labels=multi,linear_model=False,n_frames=24,model_size=512",
    "training_files=[/a.txt,/b.txt],lr=0.01,mel_offset=20",
])
def test_classifier_hparams_match_jax(overrides):
    port, ref = (ClassifierHParams.create(overrides),
                 JaxClassifierHParams.create(overrides))
    names = [f.name for f in dataclasses.fields(ClassifierHParams)]
    assert names == [f.name for f in dataclasses.fields(JaxClassifierHParams)]
    assert port.as_dict() == ref.as_dict()
    args = {"hparams": overrides, "epochs": 3, "unused": None}
    port.add_params(args)
    ref.add_params(args)
    assert port.as_dict() == ref.as_dict()
