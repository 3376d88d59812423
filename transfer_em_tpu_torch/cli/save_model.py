"""Export CLI (counterpart of transfer_em_tpu/cli/save_model.py, reference
bin/save_model.py).

    python -m transfer_em_tpu_torch.cli.save_model <name> <ckpt> <mean_x> \\
        <std_x> <mean_y> <std_y> <size> <is3d: 1|0> [wf] [--device=DEV] \\
        [--tf[=DIR]]

``<ckpt>`` is a step directory ``.../train_<exp>/<step>`` of the port's
checkpoints; the model is rebuilt on ``--device`` (default ``cuda``).
``--tf`` also writes a TF SavedModel (compat.export_tf_savedmodel) to DIR
(default ``<name>_tf``) for the reference's TF serving stack.
"""

import sys

from ..infer.export import save_model


def main(argv=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    device, tf_dir = "cuda", None
    for a in [a for a in argv if a.startswith("--device=")]:
        argv.remove(a)
        device = a.split("=", 1)[1]
    for a in [a for a in argv if a == "--tf" or a.startswith("--tf=")]:
        argv.remove(a)
        tf_dir = a.split("=", 1)[1] if "=" in a else ""
    bad = [a for a in argv if a.startswith("--")]
    if bad:
        print(f"unrecognized option(s): {' '.join(bad)}\n\n{__doc__}")
        return 1
    if len(argv) < 8:
        print(__doc__)
        return 1
    name, ckpt = argv[0], argv[1]
    meanstd_x = (float(argv[2]), float(argv[3]))
    meanstd_y = (float(argv[4]), float(argv[5]))
    size = int(argv[6])
    is3d = argv[7] == "1"
    wf = int(argv[8]) if len(argv) > 8 else 8
    save_model(name, ckpt, meanstd_x, meanstd_y, size, is3d, wf,
               device=device)
    if tf_dir is not None:
        from ..compat import export_tf_savedmodel
        export_tf_savedmodel(name, tf_dir or f"{name}_tf")
    return 0


if __name__ == "__main__":
    sys.exit(main())
