"""The port's public names against the JAX package's: each name the port
keeps as its own copy, held to the JAX value or behaviour (one case a
name), and an ``ast`` walk of every JAX module's public top-level names,
which finds nothing missing from the port but the two Pallas files (their
kernels are the port's ``csrc/``) and names a JAX module only imports; and
the port's console scripts in setup.py; and an ``inspect.signature`` walk
of every public function and class the two packages share, which finds no
JAX parameter missing from the port but the JAX-only idioms of
``EXCLUDED_PARAMS``."""

import ast
import glob
import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PALLAS_FILES = {os.path.join("ops", "pallas_conv.py"),
                os.path.join("ops", "pallas_kernels.py")}


def _shape_constant(name):
    from transfer_em_tpu import shapes as jshapes
    from transfer_em_tpu_torch import shapes
    assert getattr(shapes, name) == getattr(jshapes, name)
    assert type(getattr(shapes, name)) is int
    g = shapes.generator_shapes(shapes.DEFAULT_DIMSIZE)
    assert (g.out, g.buffer) == (shapes.DEFAULT_OUT, shapes.DEFAULT_BUFFER)


def _same_transpose_padding():
    from transfer_em_tpu.ops.convs import same_transpose_padding as jpad
    from transfer_em_tpu_torch.ops.convs import (conv_transpose_nd,
                                                 same_transpose_padding)
    for k in range(1, 8):
        for s in range(1, 5):
            assert same_transpose_padding(k, s) == jpad(k, s)
    # the generator's up conv (k4 s2) is torch's padding 3 - 2 = 1: out = 2n
    x = torch.ones(1, 5, 6, 1)
    assert conv_transpose_nd(x, torch.ones(4, 4, 1, 2)).shape == (1, 10, 12,
                                                                  2)


def _weight_init():
    import jax

    from transfer_em_tpu.models.blocks import WEIGHT_INIT as JAX_INIT
    from transfer_em_tpu_torch.models.blocks import WEIGHT_INIT, WEIGHT_STD
    n = (400, 500)
    got = WEIGHT_INIT(n, torch.Generator().manual_seed(3))
    again = WEIGHT_INIT(n, torch.Generator().manual_seed(3))
    want = np.asarray(JAX_INIT(jax.random.PRNGKey(3), n))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert torch.equal(got, again)  # the draw is the generator's
    assert not torch.equal(got, WEIGHT_INIT(n, torch.Generator()
                                            .manual_seed(4)))
    assert WEIGHT_STD == 0.02
    # the same distribution: N(0, 0.02) (2e5 draws: 4 sigma of the estimates)
    for draws in (got.numpy(), want):
        assert abs(draws.mean()) < 4 * 0.02 / np.sqrt(draws.size)
        assert abs(draws.std() / 0.02 - 1) < 4 / np.sqrt(2 * draws.size)
    assert WEIGHT_INIT((2, 3), dtype=torch.float64).dtype == torch.float64


def _generator_module():
    import jax
    import jax.numpy as jnp

    from transfer_em_tpu.infer.export import generator_module as jmodule
    from transfer_em_tpu_torch.infer.export import generator_module
    from transfer_em_tpu_torch.models.convert import params_to_jax
    for wf in (8, 32):
        gen = generator_module(wf)
        assert gen is generator_module(wf) and jmodule(wf) is jmodule(wf)
        assert gen.wf == jmodule(wf).wf == wf
        want = jmodule(wf).init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 74, 74, 74, 1), jnp.float32))
        got = params_to_jax(dict(gen.named_parameters()))
        assert (jax.tree.map(np.shape, got)
                == jax.tree.map(np.shape, jax.tree.map(np.asarray, want)))
    assert generator_module(8) is not generator_module(32)


def _native_available():
    from transfer_em_tpu import native as jnative
    from transfer_em_tpu_torch import native
    assert isinstance(native.native_available(), bool)
    assert native.native_available() == jnative.native_available()


def _infer_export(name):
    import transfer_em_tpu.infer as jinfer
    import transfer_em_tpu_torch.infer as infer
    from transfer_em_tpu_torch.infer import export, tiling
    assert name in jinfer.__all__ and name in infer.__all__
    assert getattr(infer, name) is (getattr(export, name, None)
                                    or getattr(tiling, name))
    assert set(jinfer.__all__) <= set(infer.__all__)


NAMES = {
    "shapes.DEFAULT_DIMSIZE": lambda: _shape_constant("DEFAULT_DIMSIZE"),
    "shapes.DEFAULT_OUT": lambda: _shape_constant("DEFAULT_OUT"),
    "shapes.DEFAULT_BUFFER": lambda: _shape_constant("DEFAULT_BUFFER"),
    "shapes.UP_K": lambda: _shape_constant("UP_K"),
    "ops.convs.same_transpose_padding": _same_transpose_padding,
    "models.blocks.WEIGHT_INIT": _weight_init,
    "infer.export.generator_module": _generator_module,
    "native.native_available": _native_available,
    "infer.predict_cube_from_saved_model":
        lambda: _infer_export("predict_cube_from_saved_model"),
    "infer.predict_ng_cube": lambda: _infer_export("predict_ng_cube"),
}


@pytest.mark.parametrize("name", sorted(NAMES))
def test_public_name_matches_jax(name):
    NAMES[name]()


def _top_level_names(path):
    """(defined, imported) public top-level names of a module."""
    tree = ast.parse(open(path).read(), filename=path)
    defined, imported = set(), set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            defined.add(node.name)
        elif isinstance(node, ast.Assign):
            defined |= {t.id for t in node.targets
                        if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            defined.add(node.target.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            imported |= {(a.asname or a.name).split(".")[0]
                         for a in node.names}
    return ({n for n in defined if not n.startswith("_")},
            {n for n in imported if not n.startswith("_")})


def test_public_names_walk():
    jax_root = os.path.join(REPO, "transfer_em_tpu")
    missing = {}
    for path in sorted(glob.glob(os.path.join(jax_root, "**", "*.py"),
                                 recursive=True)):
        rel = os.path.relpath(path, jax_root)
        port_path = os.path.join(REPO, "transfer_em_tpu_torch", rel)
        if rel in PALLAS_FILES:
            assert not os.path.exists(port_path)
            continue
        assert os.path.exists(port_path), f"the port has no {rel}"
        want, _ = _top_level_names(path)
        have, imported = _top_level_names(port_path)
        if want - have - imported:
            missing[rel] = sorted(want - have - imported)
    assert not missing, missing


# JAX parameters the port does not take, each with why no call needs it.
EXCLUDED_PARAMS = {
    "params": "flax keeps weights in a param tree beside the module; the "
              "port's modules hold their parameters",
    "gen_apply": "a flax module's apply function; the port passes the "
                 "module itself",
    "parent": "flax's module-tree bookkeeping (a dataclass field)",
    "name": "flax's module-tree bookkeeping (a dataclass field)",
    "fast_conv": "the opt-in to JAX's Pallas conv; the port's conv3 kernel "
                 "is its default route",
    "dropout_impl": "JAX's choice of dropout PRNG (rbg8); the port draws "
                    "from a torch.Generator",
    "rng": "a JAX PRNG key; the port takes integer seeds and "
           "torch.Generators",
    "platforms": "JAX backend selection; the port takes device=",
}
EXCLUDED_PREFIXES = {
    "donate": "XLA buffer donation; eager PyTorch updates in place",
}
# (module, name) -> parameters excluded there only, with the reason
EXCLUDED_AT = {
    ("ops", None): ({"compute_dtype"}, "the ops take the dtype of their "
                    "input (the blocks cast), as conv_nd's x.dtype does"),
    ("train.cgan", "cyclegan_losses"): (
        {"gen", "disc_x", "disc_y"}, "JAX passes flax modules beside a "
        "param tree; the port passes the four networks gg, gf, dx, dy"),
    ("models.blocks", "WEIGHT_INIT"): (
        {"key", "out_sharding"}, "a jax.nn initializer's PRNG key and "
        "output sharding; the port's draws from a torch.Generator"),
    ("train.cgan", "BoundModel"): (
        {"params_fn", "apply_fn"}, "a flax module's param getter and "
        "apply; the port binds the nn.Module itself"),
}


def _jax_modules():
    jax_root = os.path.join(REPO, "transfer_em_tpu")
    out = []
    for path in sorted(glob.glob(os.path.join(jax_root, "**", "*.py"),
                                 recursive=True)):
        rel = os.path.relpath(path, jax_root)
        if rel in PALLAS_FILES:
            continue
        mod = rel[:-3].replace(os.sep, ".")
        out.append(mod[:-len(".__init__")] if mod.endswith("__init__")
                   else mod)
    return out


def _excluded(mod, name, param):
    if param in EXCLUDED_PARAMS or any(param.startswith(p)
                                       for p in EXCLUDED_PREFIXES):
        return True
    for (m, n), (params, _) in EXCLUDED_AT.items():
        if (mod == m or mod.startswith(m + ".")) and n in (None, name) \
                and param in params:
            return True
    return False


@pytest.mark.parametrize("mod", _jax_modules())
def test_public_parameters_walk(mod):
    """Every parameter of a JAX public function or class (defined in the
    module, not imported) is a parameter of the port's counterpart, but
    the excluded idioms above."""
    import importlib
    import inspect

    jmod = importlib.import_module("transfer_em_tpu" + ("." + mod if mod
                                                        else ""))
    pmod = importlib.import_module("transfer_em_tpu_torch"
                                   + ("." + mod if mod else ""))
    defined, _ = _top_level_names(jmod.__file__)
    missing = {}
    for name in sorted(defined):
        jobj, pobj = getattr(jmod, name, None), getattr(pmod, name, None)
        if not callable(jobj) or pobj is None:
            continue
        try:
            jsig, psig = inspect.signature(jobj), inspect.signature(pobj)
        except (TypeError, ValueError):
            continue  # a builtin or a C type: nothing to walk
        gone = [p for p in jsig.parameters
                if p not in psig.parameters and not _excluded(mod, name, p)]
        if gone:
            missing[name] = gone
    assert not missing, missing


def _console_scripts():
    """setup.py's console scripts, name -> "module:function"."""
    tree = ast.parse(open(os.path.join(REPO, "setup.py")).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == "console_scripts"
                for k in node.keys)):
            scripts = ast.literal_eval(node.values[0])
            return dict(s.split("=", 1) for s in scripts)
    raise AssertionError("setup.py names no console scripts")


@pytest.mark.parametrize("name", ["tem-torch-save-model",
                                  "tem-torch-data-service",
                                  "tem-torch-model-service"])
def test_port_console_script(name):
    """Each of the port's console scripts names a callable ``main`` of the
    port, beside the JAX package's script of the same role."""
    import importlib

    scripts = _console_scripts()
    module, func = scripts[name].split(":")
    assert module.startswith("transfer_em_tpu_torch.") and func == "main"
    assert callable(getattr(importlib.import_module(module), func))
    jax_module = scripts[name.replace("tem-torch-", "tem-")].split(":")[0]
    assert module == jax_module.replace("transfer_em_tpu.",
                                        "transfer_em_tpu_torch.", 1)
