"""``python -m specpride_tpu_torch`` entry point.  ``submit`` and
``profile`` go to the serving client, ``fleet`` and ``cas-server`` to the
fleet module, ``incident-replay`` and ``incidents`` to the flight
recorder's read side, ``autotune-replay`` to the autotune audit and
``lint`` to the static analyzer, before the CLI is imported, so they start
without torch."""
import sys

if __name__ == "__main__":
    if sys.argv[1:2] in (["submit"], ["profile"]):
        from specpride_tpu_torch.serve.client import main
    elif sys.argv[1:2] in (["fleet"], ["cas-server"]):
        from specpride_tpu_torch.parallel.fleet import main
    elif sys.argv[1:2] in (["incident-replay"], ["incidents"]):
        from specpride_tpu_torch.observability.incident_cli import main
    elif sys.argv[1:2] == ["autotune-replay"]:
        from specpride_tpu_torch.autotune.cli import main
    elif sys.argv[1:2] == ["lint"]:
        from specpride_tpu_torch.analysis.runner import lint_main as main
    else:
        from specpride_tpu_torch.cli import main
    raise SystemExit(main())
