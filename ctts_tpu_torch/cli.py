"""Drop-in `ctts` command-line interface of the PyTorch/CUDA port
(parity: main, ctts.c:3930-4035; counterpart of ctts_tpu/cli.py).

    python -m ctts_tpu_torch.cli build <dataset_dir> <output.db>
    python -m ctts_tpu_torch.cli synth <database.db> "text" <output.wav> [speed]

Extensions (flags after the positional args, all optional):
    --executor=torch|native|oracle
                            waveform executor (default: torch =
                            SynthesisCore on the device, the Hopper
                            kernels on the card; native = the C++ host
                            engine of runtime/, built by make at first
                            use, and an error when it cannot be built;
                            oracle = the NumPy oracle). The JAX CLI's
                            default is native; the port's entry point
                            runs on the card.
    --device=cuda|cpu       where the torch executor runs (default: cuda,
                            an error when there is no card)
    --config=PATH           config file (default: ./config.yaml, like the C)
    --rules=PATH            normalization CSV (default: ./normalization.csv)
    --rule-flavor=glibc|full  regex flavor (default: glibc = this platform's
                            C binary behavior; see ctts_tpu_torch.text.rules)
"""

from __future__ import annotations

import sys

import numpy as np

from ctts_tpu_torch.config import _strtof, load_config
from ctts_tpu_torch.constants import MAX_SPEED, MIN_SPEED, SAMPLE_RATE
from ctts_tpu_torch.db.builder import build_database
from ctts_tpu_torch.db.reader import VoiceDatabase
from ctts_tpu_torch.plan.compiler import compile_plan
from ctts_tpu_torch.text.duration_rules import DurationRules
from ctts_tpu_torch.text.rules import NormalizationRules
from ctts_tpu_torch.utils.timing import StageTimer
from ctts_tpu_torch.utils.wav import write_wav

EXECUTORS = ("torch", "native", "oracle")
DEVICES = ("cuda", "cpu")


def _print_usage(prog: str) -> None:
    print("CTTS - Concatenative Text-to-Speech Engine (PyTorch/CUDA port)\n",
          file=sys.stderr)
    print("Usage:", file=sys.stderr)
    print("  Build database:", file=sys.stderr)
    print(f"    {prog} build <dataset_dir> <output.db>\n", file=sys.stderr)
    print("  Synthesize speech:", file=sys.stderr)
    print(f"    {prog} synth <database.db> \"text\" <output.wav> [speed]\n",
          file=sys.stderr)
    print("  Options:", file=sys.stderr)
    print("    speed  - Playback speed (0.5 to 2.0, default 1.0)",
          file=sys.stderr)


def _execute(executor: str, device: str, plan, db, db_path: str):
    if executor == "torch":
        import torch

        from ctts_tpu_torch.env import device as cuda_device
        from ctts_tpu_torch.synth.device import DeviceVoice, execute_plan_torch

        dev = cuda_device() if device == "cuda" else torch.device("cpu")
        return execute_plan_torch(plan, db,
                                  DeviceVoice(db, plan.target_rms, dev))
    if executor == "native":
        from ctts_tpu_torch.runtime.native import NativeEngine

        engine = NativeEngine(db_path)
        try:
            return engine.execute(plan)
        finally:
            engine.close()
    from ctts_tpu_torch.synth.oracle import execute_plan_oracle

    return execute_plan_oracle(plan, db)


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv if argv is None else argv)
    prog = argv[0] if argv else "ctts"

    flags = {k: v for k, _, v in
             (a.partition("=") for a in argv if a.startswith("--"))}
    args = [a for a in argv if not a.startswith("--")]

    if len(args) < 2:
        _print_usage(prog)
        return 1

    cmd = args[1]

    if cmd == "build":
        if len(args) < 4:
            print(f"Usage: {prog} build <dataset_dir> <output.db>",
                  file=sys.stderr)
            return 1
        dataset, out = args[2], args[3]
        # Path derivation incl. the reference's "sillabes" spelling
        # (ctts.c:3956-3959).
        try:
            build_database(
                f"{dataset}/letters/wavs",
                f"{dataset}/letters/letters.txt",
                f"{dataset}/syllables/wavs",
                f"{dataset}/syllables/sillabes.txt",
                out,
            )
        except OSError as e:
            print(f"Build failed: {e}", file=sys.stderr)
            return 1
        return 0

    if cmd == "synth":
        if len(args) < 5:
            print(f"Usage: {prog} synth <database.db> \"text\" <output.wav>"
                  f" [speed]", file=sys.stderr)
            return 1
        executor = flags.get("--executor", "torch")
        device = flags.get("--device", "cuda")
        if executor not in EXECUTORS or device not in DEVICES:
            print(f"Unknown --executor={executor} or --device={device} "
                  f"(executors: {', '.join(EXECUTORS)}; devices: "
                  f"{', '.join(DEVICES)})", file=sys.stderr)
            return 1

        db_path, text, out_path = args[2], args[3], args[4]
        speed = 1.0
        if len(args) > 5:
            # C strtof: unparseable → 0.0, then clamped (ctts.c:3977-3981).
            speed = float(np.float32(_strtof(args[5])))
            speed = min(max(speed, MIN_SPEED), MAX_SPEED)

        try:
            db = VoiceDatabase(db_path)
        except (OSError, ValueError):
            print(f"Failed to load database: {db_path}", file=sys.stderr)
            return 1

        config = load_config(flags.get("--config", "config.yaml"))
        # Config default_speed applies only when the CLI speed is absent
        # (ctts.c:3993-3995).
        if len(args) <= 5 and config.default_speed != 1.0:
            speed = config.default_speed

        if executor != "oracle":
            from ctts_tpu_torch.synth.plan_arrays import check_config

            try:
                check_config(config)
            except ValueError as e:
                print(f"Config refused: {e}", file=sys.stderr)
                return 1

        print(f"Loaded database with {db.unit_count} units")
        print(
            f"Config: crossfade={config.crossfade_ms:.1f}ms "
            f"(vowel={config.crossfade_vowel_ms:.1f}ms, "
            f"v2c={config.vowel_to_consonant_factor * 100:.0f}%), "
            f"word_pause={config.word_pause_ms:.1f}ms"
        )

        # Loaded (and reported) but never applied — reference parity.
        DurationRules.load("duration_rules.csv")

        # The reference's print_timing flag is a stub; here it reports
        # real per-stage wall clock (SURVEY.md §5.1). The execute stage
        # ends with the samples on the host, so it includes device work.
        timer = StageTimer(enabled=config.print_timing)

        with timer.stage("load rules"):
            rules = NormalizationRules.load(
                flags.get("--rules", "normalization.csv"),
                flavor=flags.get("--rule-flavor", "glibc"),
            )
        with timer.stage("compile plan"):
            plan = compile_plan(db, text, config, rules, speed)
        with timer.stage(f"execute ({executor})"):
            samples = _execute(executor, device, plan, db, db_path)
        timer.report()

        print(
            f"Synthesized {samples.shape[0]} samples "
            f"({samples.shape[0] / SAMPLE_RATE:.2f} seconds)"
        )
        print(f"Units found: {plan.units_found}, missing: {plan.units_missing}")

        try:
            write_wav(out_path, samples, SAMPLE_RATE)
        except OSError as e:
            print(f"Failed to write WAV: {e}", file=sys.stderr)
            return 1
        print(f"Written to {out_path}")
        return 0

    _print_usage(prog)
    return 1


if __name__ == "__main__":
    sys.exit(main())
