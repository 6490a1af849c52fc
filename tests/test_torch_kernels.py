"""keystone_tpu_torch's kernel builder on the CPU: a library is keyed by its
source and every ``csrc/*.cuh`` header the source includes, so an edited
header is rebuilt and never served from a stale library. Nothing is
compiled here."""

import os
import shutil

import pytest

pytest.importorskip("torch")

from keystone_tpu_torch.core import kernels  # noqa: E402


HEADERS = ("attention_sm90.cuh", "sm90_common.cuh")


@pytest.fixture
def csrc_copy(tmp_path):
    """The sources that include headers, and the headers, copied."""
    for name in ("flash_attention.cu", "flash_attention_step.cu", "int8_gram.cu", *HEADERS):
        shutil.copy(os.path.join(kernels.CSRC_DIR, name), tmp_path / name)
    return tmp_path


@pytest.mark.parametrize("source,headers", [
    ("flash_attention.cu", list(HEADERS)),
    ("flash_attention_step.cu", list(HEADERS)),
    ("int8_gram.cu", ["sm90_common.cuh"]),
], ids=["flash_attention.cu", "flash_attention_step.cu", "int8_gram.cu"])
def test_source_files_follow_the_header(csrc_copy, source, headers):
    """A source's key holds the headers it includes, and theirs in turn."""
    files = kernels.source_files(str(csrc_copy / source))
    assert [os.path.basename(f) for f in files] == [source, *headers]


def test_sources_without_headers_are_keyed_alone():
    name = os.path.join(kernels.CSRC_DIR, "int8_matmul.cu")
    assert kernels.source_files(name) == [name]


@pytest.mark.parametrize("source,edited", [
    ("flash_attention.cu", "attention_sm90.cuh"),
    ("flash_attention_step.cu", "attention_sm90.cuh"),
    ("flash_attention.cu", "sm90_common.cuh"),
    ("int8_gram.cu", "sm90_common.cuh"),
], ids=["flash_attention.cu", "flash_attention_step.cu", "flash_attention.cu-through-sm90_common.cuh",
        "int8_gram.cu"])
def test_editing_an_included_header_changes_the_target(csrc_copy, source, edited):
    kernel = kernels.Kernel("probe", str(csrc_copy / source))
    before = kernel._target()
    assert before == kernel._target()  # the same bytes, the same library
    header = csrc_copy / edited
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    assert kernel._target() != before


def test_a_header_the_source_does_not_include_leaves_the_target(csrc_copy):
    kernel = kernels.Kernel("probe", str(csrc_copy / "flash_attention.cu"))
    before = kernel._target()
    (csrc_copy / "unrelated.cuh").write_text("// not included\n")
    assert kernel._target() == before
