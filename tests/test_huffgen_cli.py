"""Table-compiler CLI (Python huffgen) and .def format round trips."""

import os
import subprocess
import sys

import pytest

import tpu_huffman as th
from tpu_huffman.huffgen import main as huffgen_main
from tpu_huffman.tables import parse_def

SAMPLE_DEF = """\
/* sample table in the reference .def format
   (reference: tests/test_huffman_static_table.def structure) */
#ifdef GUARD
HUFFMAN_CODE(65, "00", 0x0, 2)
HUFFMAN_CODE(66, "01", 0x1, 2)
HUFFMAN_CODE(67, "100", 0x4, 3) HUFFMAN_CODE(68, "101", 0x5, 3)
HUFFMAN_CODE(69, "110", 0x6, 3)
HUFFMAN_CODE(70, "111", 0x7, 3)
#endif
"""


@pytest.fixture
def def_file(tmp_path):
    p = tmp_path / "sample.def"
    p.write_text(SAMPLE_DEF)
    return str(p)


def test_parse_def_sample(def_file):
    with open(def_file) as f:
        specs = parse_def(f.read())
    assert len(specs) == 6
    assert {s.symbol for s in specs} == {65, 66, 67, 68, 69, 70}


def test_cli_check(def_file, capsys):
    assert huffgen_main([def_file, "--check"]) == 0
    out = capsys.readouterr().out
    assert "6 codes" in out
    assert "root_bits=" in out


def test_cli_tsv_roundtrip(def_file, tmp_path):
    tsv = str(tmp_path / "out.tsv")
    assert huffgen_main([def_file, "--tsv", tsv]) == 0
    t1 = th.HuffmanTable.from_def_file(def_file)
    t2 = th.HuffmanTable.from_tsv_file(tsv)
    assert (t1.patterns == t2.patterns).all()
    assert (t1.lengths == t2.lengths).all()
    data = b"ABCDEF" * 10
    assert th.encode(data, t2) == th.encode(data, t1)


def test_cli_npz_roundtrip(def_file, tmp_path):
    npz = str(tmp_path / "table.npz")
    assert huffgen_main([def_file, "--npz", npz]) == 0
    t = th.HuffmanTable.load(npz)
    data = b"FEDCBA" * 5
    assert th.decode(th.encode(data, t), t) == data


def test_cli_bad_table(tmp_path, capsys):
    bad = tmp_path / "bad.def"
    # 0 and 1 as 1-bit codes plus another code -> not prefix-free
    bad.write_text(
        'HUFFMAN_CODE(65, "0", 0x0, 1)\n'
        'HUFFMAN_CODE(66, "1", 0x1, 1)\n'
        'HUFFMAN_CODE(67, "10", 0x2, 2)\n'
    )
    assert huffgen_main([str(bad), "--check"]) == 1


def test_cpp_and_python_huffgen_agree(def_file, tmp_path):
    """Both table compilers emit interchangeable TSV artifacts."""
    cpp_bin = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "cpp", "build", "huffgen",
    )
    if not os.path.exists(cpp_bin):
        pytest.skip("C++ huffgen not built")
    cpp_tsv = str(tmp_path / "cpp.tsv")
    subprocess.run([cpp_bin, def_file, "--tsv", cpp_tsv], check=True)
    py_tsv = str(tmp_path / "py.tsv")
    huffgen_main([def_file, "--tsv", py_tsv])
    t_cpp = th.HuffmanTable.from_tsv_file(cpp_tsv)
    t_py = th.HuffmanTable.from_tsv_file(py_tsv)
    assert (t_cpp.patterns == t_py.patterns).all()
    assert (t_cpp.lengths == t_py.lengths).all()
