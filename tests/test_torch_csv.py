"""The port's CSV reader (`apla_tpu_torch.data.csv.read_csv`) against
`pandas.read_csv` with its defaults, which the JAX package's dataset
classes read their tables with.

On files of int, float, string, quoted, empty-field, NA-word, bool,
byte-order-mark, repeated-name, short-row and blank-line content, and on
NABirds' and ISIC2019's tables: the column names, each column's dtype, the
values (type and value; NaN where pandas has NaN), `values` and its dtype,
the rows of `iterrows`, and the operations the dataset classes use
(`isin` with str and int ids, `astype(str)`, `unique`, a boolean row
selection, `values[:, 1:].astype(float)`).
"""

import math

import numpy as np
import pandas as pd
import pytest

from apla_tpu_torch.data.csv import read_csv

CASES = {
    "int": "a,b\n1,2\n-3,+4\n 5 ,6\n",
    "float": "x,y\n1.5,2\n3,4e2\n.5,5.\n-inf,Infinity\n",
    "string": "name,label\ncat,1\ndog,0\n1_0,1\n0x1f,0\n",
    "quoted": 'a,b,c\n"x, y",1,"2"\n"q""r","3",4\n"",5,6\n',
    "empty_field": "a,b,c\n1,,x\n,2.5,\n3,4,y\n",
    "na_words": "a,b\nNA,1\nnull,2\nN/A,x\nnan,y\n",
    "bool": "a,b\nTrue,1\nfalse,2\nTRUE,3\n",
    "bool_missing": "a,b\nTrue,1\n,2\n",
    "bom": "﻿image,label\nISIC_0000000,1\n",
    "repeated_names": "a,a,b,a\n1,2,3,4\n",
    "short_row": "a,b,c\n1,2\n3,4,5\n",
    "blank_lines": "a,b\n1,2\n\n3,4\n\n",
    "nabirds": ("image_id,imagepath,class_id\n"
                "0a1b2c3d-0000-4d55-9a00-b7c1d2e3f4a5,0295/0a1b.jpg,295\n"
                "1a1b2c3d-0000-4d55-9a00-b7c1d2e3f4a5,0010/1a1b.jpg,10\n"
                "2a1b2c3d-0000-4d55-9a00-b7c1d2e3f4a5,0295/2a1b.jpg,295\n"),
    "nabirds_digit_ids": ("image_id,imagepath,class_id\n"
                          "1001,0295/1001.jpg,295\n1002,0010/1002.jpg,10\n"
                          "1003,0295/1003.jpg,295\n"),
    "isic": ("image,MEL,NV,BCC,AK,BKL,DF,VASC,SCC,UNK\n"
             "ISIC_0000000,0.0,1.0,0.0,0.0,0.0,0.0,0.0,0.0,0.0\n"
             "ISIC_0000001,0.0,0.0,0.0,0.0,0.0,0.0,0.0,1.0,0.0\n"),
    "all_numeric_rows": "a,b\n1,2.5\n3,4.0\n",
}


def _same(a, b) -> bool:
    """Equal values of the same Python / numpy type, NaN equal to NaN."""
    if isinstance(a, float) and isinstance(b, float) \
            and math.isnan(a) and math.isnan(b):
        return True
    return type(a) is type(b) and a == b


@pytest.fixture(params=sorted(CASES))
def case(request, tmp_path):
    path = tmp_path / f"{request.param}.csv"
    path.write_text(CASES[request.param], encoding="utf-8")
    return request.param, str(path)


def test_frame_matches_pandas(case):
    name, path = case
    got, want = read_csv(path), pd.read_csv(path)
    assert got.columns == list(want.columns)
    assert len(got) == len(want)
    for col in want.columns:
        assert got[col].dtype == str(want[col].dtype), col
        a, b = got[col].tolist(), want[col].tolist()
        assert all(_same(x, y) for x, y in zip(a, b)), (col, a, b)
    gv, wv = got.values, want.values
    assert gv.dtype == wv.dtype and gv.shape == wv.shape
    assert all(_same(x, y) for x, y in zip(gv.ravel().tolist(),
                                            wv.ravel().tolist()))
    rows = [(i, r.values.tolist()) for i, r in got.iterrows()]
    ref = [(i, r.values.tolist()) for i, r in want.iterrows()]
    assert [i for i, _ in rows] == [i for i, _ in ref]
    for (_, a), (_, b) in zip(rows, ref):
        assert all(_same(x, y) for x, y in zip(a, b)), (a, b)
    for col in want.columns:
        a, b = got[col].astype(str).tolist(), want[col].astype(str).tolist()
        assert all(_same(x, y) for x, y in zip(a, b)), (col, a, b)
        a, b = got[col].unique(), pd.Series(want[col].unique()).tolist()
        assert len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("ids", [["1002", "1003"], [1002, 1003],
                                 ["0a1b2c3d-0000-4d55-9a00-b7c1d2e3f4a5"]])
def test_nabirds_selection_matches_pandas(tmp_path, ids):
    """`df[df["image_id"].isin(ids)]` as the NABirds reader selects, its
    rows, and the class ids sorted as strings: an all-digit id column
    (int) matches int ids and no str id."""
    for name in ("nabirds", "nabirds_digit_ids"):
        path = tmp_path / f"{name}.csv"
        path.write_text(CASES[name])
        got, want = read_csv(str(path)), pd.read_csv(str(path))
        g, w = got[got["image_id"].isin(ids)], \
            want[want["image_id"].isin(ids)]
        assert [(i, r["imagepath"], str(r["class_id"]))
                for i, r in g.iterrows()] == \
            [(i, r["imagepath"], str(r["class_id"]))
             for i, r in w.iterrows()]
        assert sorted(got["class_id"].astype(str).unique()) == \
            sorted(want["class_id"].astype(str).unique()) == ["10", "295"]
    digits = read_csv(str(tmp_path / "nabirds_digit_ids.csv"))
    assert len(digits[digits["image_id"].isin(["1002"])]) == 0
    assert len(digits[digits["image_id"].isin([1002])]) == 1


def test_isic_table_reads_as_pandas(tmp_path):
    path = tmp_path / "gt.csv"
    path.write_text(CASES["isic"])
    got, want = read_csv(str(path)).values, pd.read_csv(str(path)).values
    np.testing.assert_array_equal(got[:, 1:].astype(float).argmax(axis=1),
                                  want[:, 1:].astype(float).argmax(axis=1))
    assert got[:, 0].tolist() == want[:, 0].tolist()


def test_refused_files_raise(tmp_path):
    long_row = tmp_path / "long.csv"
    long_row.write_text("a,b\n1,2,3\n")
    with pytest.raises(ValueError, match="3 fields"):
        read_csv(str(long_row))
    empty = tmp_path / "empty.csv"
    empty.write_text("")
    with pytest.raises(ValueError, match="no columns"):
        read_csv(str(empty))
