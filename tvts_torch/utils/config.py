"""JSON experiment configuration (counterpart of tvts_tpu/utils/config.py).

The reference's `ConfigParser` (v2/parse_config_dist_multi.py):
- a JSON config file plus command-line flags that override nested keys
  (`CustomArgs` tuples; `_set_by_path`);
- `--resume ckpt` reloads the config saved beside the checkpoint;
- timestamped run directories (save, log) and the resolved config.json
  written there, unless `test`;
- the same JSON schema: name, arch {type, args}, data_loader, loss, metrics,
  trainer {epochs, save_dir, ...}, visualizer.
It reads the JAX package's `tvts_tpu/configs/*.json` by path, as they are.
`initialize_dataset_loader` builds the port's dataset and `ShardedLoader`.
"""

from __future__ import annotations

import json
from datetime import datetime
from functools import reduce
from operator import getitem
from pathlib import Path


class ConfigParser:
    def __init__(self, config: dict, resume: str | None = None,
                 run_id: str | None = None, test: bool = False):
        self._config = config
        self.resume = resume

        save_dir = Path(config.get("trainer", {}).get("save_dir", "./results"))
        if run_id is None:
            run_id = datetime.now().strftime("%m%d_%H%M%S")
        exper_name = config.get("name", "exp")
        self._save_dir = save_dir / "models" / exper_name / run_id
        self._log_dir = save_dir / "log" / exper_name / run_id
        self._web_log_dir = save_dir / "web" / exper_name / run_id
        if not test:
            self._save_dir.mkdir(parents=True, exist_ok=True)
            self._log_dir.mkdir(parents=True, exist_ok=True)
            write_json(self._config, self._save_dir / "config.json")

    @classmethod
    def from_args(cls, args, options=(), test: bool = False) -> "ConfigParser":
        """args: an argparse.Namespace with .config / .resume; options:
        `CustomArgs` whose flag, where given, overrides its nested target."""
        resume = getattr(args, "resume", None)
        if resume and not getattr(args, "config", None):
            cfg_path = Path(resume).parent / "config.json"
        else:
            if not getattr(args, "config", None):
                raise ValueError("config file must be specified")
            cfg_path = Path(args.config)
        config = read_json(cfg_path)
        if resume and getattr(args, "config", None):
            config.update(read_json(Path(args.config)))

        for opt in options:
            flag = opt.flags[-1].lstrip("-").replace("-", "_")
            value = getattr(args, flag, None)
            if value is not None:
                _set_by_path(config, opt.target, value)
        return cls(config, resume=resume, test=test)

    def initialize_dataset_loader(self, spec: dict, overrides: dict | None = None):
        """(dataset, ShardedLoader) from one data_loader config dict. The keys
        the JAX package pops are popped here too (cut_webvid, and the
        reference-only prefix and index)."""
        from tvts_torch.data.datasets import dataset_loader
        from tvts_torch.data.loader import ShardedLoader

        args = dict(spec["args"])
        if overrides:
            args.update(overrides)
        loader_kwargs = {
            "batch_size": args.pop("batch_size", 16),
            "shuffle": args.pop("shuffle", True),
            "num_workers": args.pop("num_workers", 8),
        }
        args.pop("cut_webvid", None)
        name = args.pop("dataset_name")
        cut = args.pop("cut", None)
        for k in ("prefix", "index"):  # reference-only knobs
            args.pop(k, None)
        ds = dataset_loader(name, args.pop("text_params", {}),
                            args.pop("video_params", {}),
                            args.pop("data_dir"), cut=cut, **args)
        return ds, ShardedLoader(ds, **loader_kwargs)

    def __getitem__(self, name):
        return self._config[name]

    def get(self, name, default=None):
        return self._config.get(name, default)

    @property
    def config(self):
        return self._config

    @property
    def save_dir(self):
        return self._save_dir

    @property
    def log_dir(self):
        return self._log_dir


class CustomArgs:
    """(flags, type, nested config target), the reference's namedtuple."""

    def __init__(self, flags, type, target):
        self.flags = flags
        self.type = type
        self.target = target


def read_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def write_json(obj, path):
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)


def _set_by_path(tree: dict, keys: str, value):
    keys = keys.split(";")
    reduce(getitem, keys[:-1], tree)[keys[-1]] = value
