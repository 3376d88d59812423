"""Generate .ipynb renditions of the PyTorch port's five reference-recipe
scripts.

The port's own copy of ``examples/make_notebooks.py``: the scripts in this
directory stay the source of truth, the notebooks carry the reference's
notebook names, and tests/test_torch_notebooks.py asserts the committed
notebooks are regeneration-fresh.  A notebook's path-setup cell puts the
repo root on ``sys.path`` when it is run from ``examples/torch/``; its
recipes run on the card (``device="cuda"``, the default) or, given
``device="cpu"``, without one.

Run:  python examples/torch/make_notebooks.py [outdir]
"""

import ast
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

# script -> (notebook name, final invocation cell)
RECIPES = {
    "simple_training_2d.py": (
        "simple_training.ipynb",
        "main(epochs=10)  # main(epochs=10, device=\"cpu\") runs without a card\n",
    ),
    "generator_training_3d.py": (
        "generator_training3D.ipynb",
        "# Point these at your two EM volumes ('bucket/path' GCS tensorstore,\n"
        "# 'file:///path' local precomputed, or '/path/vol.npy'):\n"
        "loc_x = \"file:///path/to/volumeX\"\n"
        "loc_y = \"file:///path/to/volumeY\"\n"
        "main(loc_x, loc_y)\n",
    ),
    "cloudrun_test_3d.py": (
        "3dcloudrun_test.ipynb",
        "main()\n",
    ),
    "run_local_predict.py": (
        "run_local_predict.ipynb",
        "# ckpt_step: a checkpoint saved by the training notebooks, e.g. 10\n"
        "main(ckpt_step=10)\n",
    ),
    "run_cloud_predict_service.py": (
        "run_cloud_predict_service.ipynb",
        "main()\n",
    ),
}

PATH_SETUP = ('sys.path.insert(0, os.path.abspath("../.."))'
              "  # repo root, when run from examples/torch/\n")


def _cell(kind, source):
    cell = {"cell_type": kind, "metadata": {}, "source": source.splitlines(
        keepends=True)}
    if kind == "code":
        cell.update(execution_count=None, outputs=[])
    return cell


def script_to_cells(path, final_cell):
    src = open(path).read()
    lines = src.splitlines(keepends=True)
    tree = ast.parse(src)
    cells = []

    doc = ast.get_docstring(tree)
    if doc:
        # first docstring PARAGRAPH (unwrapped) is the title; rest is prose
        head, _, rest = doc.partition("\n\n")
        title = " ".join(head.split())
        cells.append(_cell("markdown", f"# {title}\n\n{rest.strip()}\n"))

    body = tree.body[1:] if doc else tree.body
    pending = []  # consecutive simple-statement segments -> one cell

    def flush():
        if not pending:
            return
        cells.append(_cell("code", "\n".join(pending) + "\n"))
        pending.clear()

    for node in body:
        # Slice from the first decorator, not node.lineno — since py3.8 a
        # decorated def/class's lineno points at the `def`, and slicing
        # there would silently drop `@...` lines from the notebook.
        start = min([node.lineno]
                    + [d.lineno for d in getattr(node, "decorator_list", [])])
        seg = "".join(lines[start - 1:node.end_lineno]).rstrip()
        if "sys.path.insert" in seg and "__file__" in seg:
            # __file__ doesn't exist in a notebook: substitute a cwd-based
            # path setup in place (same position, no duplicate imports).
            pending.append(PATH_SETUP.rstrip())
            continue
        if (isinstance(node, ast.If) and isinstance(node.test, ast.Compare)
                and getattr(node.test.left, "id", "") == "__name__"):
            continue  # argv guard -> the explicit final cell
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            flush()
            cells.append(_cell("code", seg + "\n"))
        else:
            pending.append(seg)
    flush()
    cells.append(_cell("code", final_cell))
    return cells


def make_notebook(script, final_cell):
    return {
        "cells": script_to_cells(os.path.join(HERE, script), final_cell),
        "metadata": {
            "kernelspec": {"display_name": "Python 3",
                           "language": "python", "name": "python3"},
            "language_info": {"name": "python"},
        },
        "nbformat": 4,
        "nbformat_minor": 5,
    }


def main(outdir=HERE):
    for script, (nb_name, final_cell) in RECIPES.items():
        nb = make_notebook(script, final_cell)
        out = os.path.join(outdir, nb_name)
        with open(out, "w") as f:
            json.dump(nb, f, indent=1)
            f.write("\n")
        print(f"{script} -> {out} ({len(nb['cells'])} cells)")


if __name__ == "__main__":
    main(*(sys.argv[1:2] or [HERE]))
