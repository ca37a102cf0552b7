"""PyTorch + CUDA port of ``deepspeed_tpu`` for NVIDIA Hopper.

The JAX package stays the reference; this package mirrors its module
tree (``models/``, ``ops/``, ``runtime/``, ``inference/``, ``comm/``,
``accelerator/``, ``linear/``) so each module's counterpart is found under
the same name, and its public API is the JAX package's one-card API:
:func:`initialize` (the hybrid engine when ``hybrid_engine.enabled``),
:func:`init_inference`, :func:`init_distributed`, every training-config
key.  Nothing here imports JAX or ``deepspeed_tpu``.  Entry points run
on ``cuda`` unless ``device="cpu"`` is asked for; on the CPU every
hand-written kernel is replaced by its plain PyTorch version.

Training runs across rank processes too (:func:`init_distributed` over
``torch.distributed``, :class:`MeshTopology` over its process groups,
ZeRO 0-3, hpZ, MiCS and the quantised gradient wire; the processes come
from ``deepspeed_tpu_torch.launcher``).  Not here yet, waiting for their
ROADMAP Queue 1 item: ``pipe`` and ``PipelineEngine`` (11h).
"""

from .version import __version__  # noqa: F401

from . import comm  # noqa: F401
from .accelerator import get_accelerator  # noqa: F401
from .runtime.config import DeepSpeedTPUConfig, load_config  # noqa: F401
from .runtime.engine import DeepSpeedEngine, TrainState  # noqa: F401
from .parallel.topology import MeshTopology, TopologyConfig  # noqa: F401
from .runtime import zero  # noqa: F401
from . import moe  # noqa: F401
from . import checkpoint  # noqa: F401
from . import monitor  # noqa: F401
from . import ops  # noqa: F401
from . import module_inject  # noqa: F401
from . import utils  # noqa: F401
from .runtime.hybrid_engine import DeepSpeedHybridEngine  # noqa: F401
from .runtime.lr_schedules import add_tuning_arguments  # noqa: F401
from .inference.engine import InferenceEngine  # noqa: F401
from .inference.engine import InferenceConfig as DeepSpeedInferenceConfig  # noqa: F401
from .utils.logging import log_dist, logger  # noqa: F401


def initialize(args=None,
               model=None,
               optimizer=None,
               model_parameters=None,
               training_data=None,
               lr_scheduler=None,
               mpu=None,
               dist_init_required=None,
               collate_fn=None,
               config=None,
               config_params=None,
               *,
               device=None,
               topology=None):
    """Build a training engine (JAX ``deepspeed_tpu.initialize``,
    ``__init__.py:51``, the same signature; ``device`` is a keyword:
    None is the card, ``"cpu"`` the plain versions).  The config is
    ``config``, else ``config_params``, else the JSON file named by
    ``args.deepspeed_config``.  ``hybrid_engine.enabled`` builds
    :class:`DeepSpeedHybridEngine`.  ``model_parameters`` seeds the
    masters.  ``optimizer``, ``mpu`` and ``dist_init_required`` are
    accepted and unused, as in JAX; ``topology`` (a
    :class:`MeshTopology`) overrides the config's mesh.  Returns
    ``(engine, optimizer, dataloader, lr_scheduler)``."""
    config = config if config is not None else config_params
    if args is not None and config is None:
        config = getattr(args, "deepspeed_config", None)
    cfg = load_config(config)
    cls = DeepSpeedHybridEngine if cfg.hybrid_engine.enabled \
        else DeepSpeedEngine
    kw = {} if topology is None else {"topology": topology}
    engine = cls(model=model, config=cfg,
                 model_parameters=model_parameters,
                 lr_scheduler=lr_scheduler, device=device,
                 training_data=training_data, collate_fn=collate_fn, **kw)
    return (engine, engine.optimizer, engine.training_dataloader,
            engine.lr_scheduler)


def init_distributed(dist_backend="nccl", **kwargs):
    return comm.init_distributed(dist_backend=dist_backend, **kwargs)


def init_inference(model=None, config=None, **kwargs):
    """Build a v1 inference engine (JAX ``init_inference``):
    :class:`InferenceEngine` over the ragged serving engine."""
    return InferenceEngine(model=model, config=config, **kwargs)


def add_config_arguments(parser):
    """Add the DeepSpeed argument group to an argparse parser:
    ``--deepspeed`` and ``--deepspeed_config <json path>``."""
    group = parser.add_argument_group(
        "DeepSpeed", "DeepSpeed-TPU configurations")
    group.add_argument(
        "--deepspeed", default=False, action="store_true",
        help="Enable DeepSpeed (helper flag for user code)")
    group.add_argument(
        "--deepspeed_config", default=None, type=str,
        help="DeepSpeed json configuration file.")
    return parser


def default_inference_config():
    """The default ragged (v2) engine config as a plain dict."""
    import dataclasses
    from .inference.v2 import RaggedInferenceEngineConfig
    return dataclasses.asdict(RaggedInferenceEngineConfig())
