"""Typed environment-backed configuration for the PyTorch/CUDA port.

The same fields, env-var names, validators and layers (defaults <
configs/models.yaml < .env < process env) as ``vis_tpu.utils.config``, with
two differences:

- the engine provider is ``"cuda"`` (the port's engines on a torch device),
  and every provider defaults to it; where ``configs/models.yaml`` names the
  JAX package's provider ``"tpu"``, the yaml layer reads it as ``"cuda"``
  (``YAML_PROVIDER_MAP``), so one models.yaml serves both packages.  An
  explicit ``tpu`` in ``.env`` or the process env is not mapped: the port's
  agents refuse it;
- ``TORCH_DEVICE`` (default ``cuda:0``) is the torch device the port's
  engines live on; the CPU tests set ``cpu``.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

from pydantic import BaseModel, Field, ValidationError, field_validator

_VALID_LOG_LEVELS = {"DEBUG", "INFO", "WARNING", "ERROR", "CRITICAL"}
_VALID_CRITICALITIES = {"low", "medium", "high"}
_VALID_ENVIRONMENTS = {"development", "staging", "production"}


def _parse_env_file(path: Path) -> Dict[str, str]:
    """Parse a `.env`-style file into a dict.  Lines are KEY=VALUE; `#` comments
    and blank lines are ignored; surrounding single/double quotes are stripped."""
    values: Dict[str, str] = {}
    if not path.exists():
        return values
    for raw_line in path.read_text().splitlines():
        line = raw_line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        key, _, value = line.partition("=")
        key = key.strip()
        value = value.strip()
        if len(value) >= 2 and value[0] == value[-1] and value[0] in "\"'":
            value = value[1:-1]
        if key:
            values[key] = value
    return values


def _coerce_bool(value: str) -> bool:
    return value.strip().lower() in {"1", "true", "yes", "on"}


class Config(BaseModel):
    """Application configuration, populated from env vars / `.env`.

    Field names are lowercase; each maps to the UPPER_CASE env var of the same
    name (the reference's alias scheme, reference utils/config.py:23-192).
    """

    # --- Model selection (on-device engines replace remote providers) -----
    vlm_inspector_model: str = "Qwen/Qwen2.5-VL-7B-Instruct"
    vlm_inspector_temperature: float = 0.1
    vlm_inspector_max_tokens: int = 2048
    # Per-role JSON-close floor override (None = CONSTRAINED_JSON_MIN_TOKENS).
    # Bench fixtures pin floor≈budget per role so decode lengths reproduce a
    # recorded transcript instead of drifting with compiled-graph content.
    vlm_inspector_min_tokens: Optional[int] = None
    vlm_inspector_provider: str = "cuda"  # "cuda" | "mock"

    vlm_auditor_model: str = "meta-llama/Llama-3.2-11B-Vision-Instruct"
    vlm_auditor_temperature: float = 0.1
    vlm_auditor_max_tokens: int = 2048
    vlm_auditor_min_tokens: Optional[int] = None
    vlm_auditor_provider: str = "cuda"

    explainer_model: str = "meta-llama/Llama-3.1-8B-Instruct"
    explainer_temperature: float = 0.3
    explainer_max_tokens: int = 2048
    explainer_provider: str = "cuda"

    # --- Safety thresholds (reference utils/config.py:94-118) --------------
    confidence_threshold: float = 0.85
    max_defects_auto: int = 2
    vlm_agreement_required: bool = True
    high_criticality_requires_review: bool = True
    low_confidence_threshold: float = 0.5
    critical_defect_types: str = "crack,corrosion,missing_part,deformation"

    # --- Persistence --------------------------------------------------------
    database_path: str = "inspections.db"
    database_echo: bool = False
    chat_history_db: str = "chat_history.db"

    # --- Files / uploads ----------------------------------------------------
    upload_dir: str = "uploads"
    report_dir: str = "reports"
    log_dir: str = "logs"
    max_file_size_mb: int = 10
    allowed_extensions: str = "jpg,jpeg,png,webp"

    # --- Logging ------------------------------------------------------------
    log_level: str = "INFO"
    log_format: str = "detailed"
    log_to_console: bool = True
    log_to_file: bool = True

    # --- Engine / serving ---------------------------------------------------
    # api_* existed for the reference's HTTP transport (retry/backoff around
    # HuggingFace/Groq calls).  On-pod there is no HTTP inference layer;
    # they are accepted so reference `.env` files load unchanged, and
    # api_timeout bounds the scheduler's blocking generate() helper.
    api_timeout: int = 60
    api_max_retries: int = 3
    api_retry_backoff: int = 2
    enable_streaming: bool = True     # false => /api/chat sends the whole reply unchunked
    max_concurrent_calls: int = 3
    max_image_dimension: int = 2048
    auditor_max_image_dimension: int = 1024

    # --- Chat ---------------------------------------------------------------
    enable_chat_memory: bool = True
    max_chat_history: int = 50

    # --- App ----------------------------------------------------------------
    app_title: str = "Vision Inspection System (GPU)"
    default_criticality: str = "medium"
    show_debug_info: bool = False
    enable_analytics: bool = True

    # --- Runtime flags ------------------------------------------------------
    environment: str = "development"
    skip_health_checks: bool = False
    use_mock_responses: bool = False
    verbose_errors: bool = True

    # --- Device and serving (new in this framework) ------------------------
    torch_device: str = "cuda:0"     # the torch device of the port's engines ("cpu" in the tests)
    mesh_shape: str = "1x1"          # "data x model" (read by the JAX package; the port serves one device)
    model_dtype: str = "bfloat16"
    checkpoint_dir: str = "checkpoints"
    # Cache the converted framework pytree in Orbax next to the checkpoint
    # after the first safetensors conversion; later engine builds restore it
    # directly (skips the shard merge + tensor-name mapping — minutes at 7B+
    # on a slow host).  Costs a second on-disk copy of the weights.
    orbax_convert_cache: bool = False
    kv_cache_max_tokens: int = 8192   # per-request KV budget
    paged_kv_cache: bool = False      # scheduler KV = shared page pool instead of dense slots
    kv_page_size: int = 128           # page size (tokens) of the paged-KV pool
    kv_pool_tokens: int = 16384       # total tokens the page pool holds (paged_kv_cache=true)
    prefill_buckets: str = "512,1024,2048,4096,8192"  # padded prefill lengths
    decode_batch_size: int = 8        # continuous-batching decode width
    quantization: str = "none"        # "none" | "int8" | "int4" weight-only (decoder + vocab) quant
    vocab_quantization: str = "same"  # vocab projection precision: "same" (= quantization) | "int8" | "int4" | "none"; measured on-chip the 152k vocab matmul is int4 2.40 / int8 2.60 / bf16 3.63 ms (tools/probe_vocab_head.py) — precision is an HBM-capacity knob, not a decode-latency one
    kv_quantization: str = "none"     # "none" | "int8": KV caches (per-request, scheduler slots, page pools) stored int8 with per-(token, head) scales packed into one extra head row — 1.6-1.8x less KV HBM; decode numerics change slightly (quantized keys/values), token streams stay deterministic
    inspector_vocab_quantization: str = ""  # per-role override ("" = follow vocab_quantization)
    auditor_vocab_quantization: str = ""    # per-role override for the auditor engine ("" = follow vocab_quantization); single-chip profiles use these to shape the HBM budget (e.g. int8 head only on the explainer, whose decode is the E2E tail)
    explainer_vocab_quantization: str = ""  # per-role override ("" = follow vocab_quantization)
    dev_profile: str = "small"        # weightless engines: "small" (2B-ish) | "target" (real 7B/11B/8B dims)
    continuous_batching: bool = False # share batched decode slots across requests
    batching_roles: str = "all"       # csv of agent roles that attach a scheduler when continuous_batching=true ("all" = every engine); slot KV is decode_batch_size x kv_cache_max_tokens per scheduled engine, so large-model single-chip profiles scope it (e.g. "explainer")
    speculative_decoding: str = "none"  # "pld" = prompt-lookup self-drafting
    prefix_caching: bool = False      # reuse shared text-prompt-head KV
    constrained_json: bool = False    # JSON-grammar-masked decode for inspector/auditor/decision-support (serving/constrained.py)
    constrained_json_min_tokens: int = 0  # block closing the JSON root before this many tokens (0 = no floor)
    constrained_schema: bool = False  # schema-exact decode: agents' outputs forced to the full key skeleton + typed values (serving/schema.py); agents treat it as implying json_mode even with constrained_json=false
    constrained_lookahead: int = 0    # >=2: window size for forced-run fast-forward decode (skeleton tokens ride one weight pass; 0/1 = off)
    device_preprocess: bool = False   # vision preprocessing on device (ops/preprocess_device.py) instead of host PIL
    decode_chunk: int = 64            # fused decode tokens per device dispatch (host EOS check between chunks); raise on high-RTT links
    scheduler_decode_chunk: int = 32  # batched-scheduler chunk (smaller than decode_chunk: admissions join between chunks; device-side early exit bounds the tail)
    vision_parallel: str = "tp"       # multi-chip vision encode: "tp" (head-sharded params) | "sp" (Ulysses sequence-parallel, replicated params)
    chunked_prefill_tokens: int = 0   # scheduler: split long prompt prefills into N-token segments interleaved with decode chunks (0 = whole-prompt prefill)
    profile_dir: str = ""             # non-empty => torch.profiler traces per pipeline phase

    # ------------------------------------------------------------------
    # Validators (same rules as reference utils/config.py:198-258)
    # ------------------------------------------------------------------
    @field_validator("confidence_threshold", "low_confidence_threshold")
    @classmethod
    def _check_unit_interval(cls, v: float) -> float:
        if not 0.0 <= v <= 1.0:
            raise ValueError(f"threshold must be within [0, 1], got {v}")
        return v

    @field_validator("log_level")
    @classmethod
    def _check_log_level(cls, v: str) -> str:
        upper = v.upper()
        if upper not in _VALID_LOG_LEVELS:
            raise ValueError(f"invalid log level {v!r}; expected one of {sorted(_VALID_LOG_LEVELS)}")
        return upper

    @field_validator("default_criticality")
    @classmethod
    def _check_criticality(cls, v: str) -> str:
        lower = v.lower()
        if lower not in _VALID_CRITICALITIES:
            raise ValueError(f"invalid criticality {v!r}; expected one of {sorted(_VALID_CRITICALITIES)}")
        return lower

    @field_validator("environment")
    @classmethod
    def _check_environment(cls, v: str) -> str:
        lower = v.lower()
        if lower not in _VALID_ENVIRONMENTS:
            raise ValueError(f"invalid environment {v!r}; expected one of {sorted(_VALID_ENVIRONMENTS)}")
        return lower

    @field_validator("quantization")
    @classmethod
    def _check_quantization(cls, v: str) -> str:
        lower = v.lower()
        if lower not in ("none", "int8", "int4"):
            raise ValueError(
                f"quantization must be 'none', 'int8' or 'int4', got {v!r}"
            )
        return lower

    @field_validator("dev_profile")
    @classmethod
    def _check_dev_profile(cls, v: str) -> str:
        lower = v.lower()
        if lower not in ("small", "target"):
            raise ValueError(f"dev_profile must be 'small' or 'target', got {v!r}")
        return lower

    @field_validator("vision_parallel")
    @classmethod
    def _check_vision_parallel(cls, v: str) -> str:
        lower = v.lower()
        if lower not in ("tp", "sp"):
            raise ValueError(f"vision_parallel must be 'tp' or 'sp', got {v!r}")
        return lower

    @field_validator("mesh_shape")
    @classmethod
    def _check_mesh_shape(cls, v: str) -> str:
        parts = v.lower().split("x")
        # Exactly "data x model": downstream `dp, tp = mesh_shape_tuple`
        # (serving/engine.py dp_submeshes) unpacks two values — a bare "8"
        # or "2x2x2" would crash at engine build instead of failing here
        # with the readable CONFIGURATION ERROR.
        if len(parts) != 2 or not all(
            p.isdigit() and int(p) >= 1 for p in parts
        ):
            raise ValueError(f"mesh_shape must look like '2x4', got {v!r}")
        return v.lower()

    # ------------------------------------------------------------------
    # Helper properties
    # ------------------------------------------------------------------
    @property
    def critical_defect_types_list(self) -> List[str]:
        return [t.strip().lower() for t in self.critical_defect_types.split(",") if t.strip()]

    @property
    def allowed_extensions_list(self) -> List[str]:
        return [e.strip().lower().lstrip(".") for e in self.allowed_extensions.split(",") if e.strip()]

    @property
    def is_production(self) -> bool:
        return self.environment == "production"

    @property
    def is_development(self) -> bool:
        return self.environment == "development"

    @property
    def mesh_shape_tuple(self) -> tuple:
        return tuple(int(p) for p in self.mesh_shape.split("x"))

    @property
    def prefill_bucket_list(self) -> List[int]:
        return sorted(int(b) for b in self.prefill_buckets.split(",") if b.strip())

    def get_upload_dir(self) -> Path:
        p = Path(self.upload_dir)
        p.mkdir(parents=True, exist_ok=True)
        return p

    def get_report_dir(self) -> Path:
        p = Path(self.report_dir)
        p.mkdir(parents=True, exist_ok=True)
        return p

    def get_log_dir(self) -> Path:
        p = Path(self.log_dir)
        p.mkdir(parents=True, exist_ok=True)
        return p

    def get_checkpoint_dir(self) -> Path:
        p = Path(self.checkpoint_dir)
        p.mkdir(parents=True, exist_ok=True)
        return p


# configs/models.yaml — per-agent model/temperature/max_tokens/provider.
# The reference ships config/models.yaml but never reads it (SURVEY §2 #34);
# here it is a real config layer: defaults < models.yaml < .env < env vars.
MODELS_YAML_PATH = (
    Path(__file__).resolve().parent.parent.parent / "configs" / "models.yaml"
)

_MODELS_YAML_FIELDS = {
    # yaml section -> {yaml key: Config field}
    "inspector": {
        "model_id": "vlm_inspector_model",
        "temperature": "vlm_inspector_temperature",
        "max_tokens": "vlm_inspector_max_tokens",
        "provider": "vlm_inspector_provider",
    },
    "auditor": {
        "model_id": "vlm_auditor_model",
        "temperature": "vlm_auditor_temperature",
        "max_tokens": "vlm_auditor_max_tokens",
        "provider": "vlm_auditor_provider",
    },
    "explainer": {
        "model_id": "explainer_model",
        "temperature": "explainer_temperature",
        "max_tokens": "explainer_max_tokens",
        "provider": "explainer_provider",
    },
}


# The JAX package's engine provider in configs/models.yaml -> the port's.
YAML_PROVIDER_MAP = {"tpu": "cuda"}


def _load_models_yaml(path: Optional[Path] = None) -> Dict[str, str]:
    """Per-agent settings from configs/models.yaml as UPPER_CASE source
    entries, providers mapped through ``YAML_PROVIDER_MAP``; {} when the
    file is absent or malformed (never fatal)."""
    yaml_path = path or MODELS_YAML_PATH
    try:
        if not yaml_path.exists():
            return {}
        import yaml

        with open(yaml_path) as fh:
            doc = yaml.safe_load(fh) or {}
    except Exception as exc:  # malformed yaml never blocks startup
        print(f"Warning: could not load {yaml_path}: {exc}", file=sys.stderr)
        return {}
    out: Dict[str, str] = {}
    for section, mapping in _MODELS_YAML_FIELDS.items():
        entries = doc.get(section)
        if not isinstance(entries, dict):
            continue
        for yaml_key, field_name in mapping.items():
            if yaml_key in entries and entries[yaml_key] is not None:
                value = str(entries[yaml_key])
                if yaml_key == "provider":
                    value = YAML_PROVIDER_MAP.get(value.strip().lower(), value)
                out[field_name.upper()] = value
    return out


def _load_from_env(env_file: Optional[Path] = None, **overrides: Any) -> Config:
    """Build a Config from (lowest→highest precedence) defaults,
    `configs/models.yaml`, `.env`, process env, explicit overrides."""
    source: Dict[str, str] = {}
    source.update(_load_models_yaml())
    env_path = env_file or Path(".env")
    source.update(_parse_env_file(env_path))
    for field_name in Config.model_fields:
        env_key = field_name.upper()
        if env_key in os.environ:
            source[env_key] = os.environ[env_key]

    kwargs: Dict[str, Any] = {}
    for field_name, field_info in Config.model_fields.items():
        env_key = field_name.upper()
        if env_key not in source:
            continue
        raw = source[env_key]
        annotation = field_info.annotation
        if annotation is bool:
            kwargs[field_name] = _coerce_bool(raw)
        else:
            kwargs[field_name] = raw
    kwargs.update(overrides)
    return Config(**kwargs)


_config: Optional[Config] = None


def _report_config_error(exc: ValidationError) -> None:
    """Readable per-field error table (reference utils/config.py:330-346)."""
    print("=" * 72, file=sys.stderr)
    print("CONFIGURATION ERROR — fix the following and restart:", file=sys.stderr)
    for err in exc.errors():
        loc = ".".join(str(p) for p in err["loc"])
        print(f"  - {loc}: {err['msg']}", file=sys.stderr)
    print("=" * 72, file=sys.stderr)


def get_config(reload: bool = False, **overrides: Any) -> Config:
    """Return the process-wide Config singleton (reference utils/config.py:313).

    Fails fast with a readable error listing every invalid field, then exits —
    matching the reference's SystemExit-on-invalid behavior (utils/config.py:330-346).
    """
    global _config
    if overrides:
        # Overrides build a TRANSIENT view: assigning it to the singleton
        # would silently reconfigure every other caller of get_config()
        # (and the module-level `config` proxy) for the process lifetime.
        try:
            return _load_from_env(**overrides)
        except ValidationError as exc:
            _report_config_error(exc)
            raise SystemExit(1) from exc
    if _config is None or reload:
        try:
            _config = _load_from_env()
        except ValidationError as exc:
            _report_config_error(exc)
            raise SystemExit(1) from exc
    return _config


class _ConfigProxy:
    """Lazy attribute proxy so `from vis_tpu_torch.utils.config import config` gives a
    live view of the singleton without forcing load at import time."""

    def __getattr__(self, name: str) -> Any:
        return getattr(get_config(), name)

    def __repr__(self) -> str:  # pragma: no cover
        return repr(get_config())


config = _ConfigProxy()

__all__ = ["Config", "YAML_PROVIDER_MAP", "get_config", "config"]
