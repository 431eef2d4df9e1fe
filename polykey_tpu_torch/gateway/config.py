"""Dev-client configuration with the reference's precedence model (the
counterpart of the reference package's polykey_tpu/gateway/config.py, which
follows the Go reference's internal/config/config.go):

- precedence: defaults → CLI flags → env vars (env wins over flags) →
  runtime-based server-address auto-detection;
- flags: -server / -timeout / -log-level / -env;
- env: POLYKEY_SERVER_ADDR / POLYKEY_TIMEOUT / POLYKEY_LOG_LEVEL / POLYKEY_ENV;
- runtime detection order: kubernetes → podman → containerd → docker → local,
  probing the serviceaccount dir / KUBERNETES_SERVICE_HOST, the
  ``container`` env var, /.dockerenv, and /proc/1/cgroup;
- detected addresses: kubernetes → polykey-service:50051, any container
  runtime → polykey-server:50051, local → localhost:50051.

Standard library only (no YAML): the client runs wherever the server does.
"""

from __future__ import annotations

import argparse
import enum
import os
import re
import socket
from dataclasses import dataclass, field
from typing import Optional, Sequence


class RuntimeEnvironment(enum.Enum):
    LOCAL = "local"
    DOCKER = "docker"
    KUBERNETES = "kubernetes"
    CONTAINERD = "containerd"
    PODMAN = "podman"

    def __str__(self) -> str:
        return self.value


_K8S_SERVICEACCOUNT = "/var/run/secrets/kubernetes.io/serviceaccount"
_DOCKERENV = "/.dockerenv"
_CGROUP_FILE = "/proc/1/cgroup"


class RuntimeDetector:
    """Detects where the process is running (config.go DetectRuntime)."""

    def detect_runtime(self) -> RuntimeEnvironment:
        if self._is_kubernetes():
            return RuntimeEnvironment.KUBERNETES
        if self._is_podman():
            return RuntimeEnvironment.PODMAN
        if self._is_containerd():
            return RuntimeEnvironment.CONTAINERD
        if self._is_docker():
            return RuntimeEnvironment.DOCKER
        return RuntimeEnvironment.LOCAL

    def _is_kubernetes(self) -> bool:
        return os.path.exists(_K8S_SERVICEACCOUNT) or bool(
            os.environ.get("KUBERNETES_SERVICE_HOST")
        )

    def _is_podman(self) -> bool:
        return os.environ.get("container") == "podman" or self._cgroup_has("podman")

    def _is_containerd(self) -> bool:
        return self._cgroup_has("containerd")

    def _is_docker(self) -> bool:
        return os.path.exists(_DOCKERENV) or self._cgroup_has("docker")

    @staticmethod
    def _cgroup_has(runtime: str) -> bool:
        try:
            with open(_CGROUP_FILE, encoding="utf-8") as f:
                content = f.read()
        except OSError:
            return False
        return runtime in content


_DURATION_RE = re.compile(r"(\d+(?:\.\d+)?)(ns|us|µs|ms|s|m|h)")
_DURATION_UNITS = {
    "ns": 1e-9,
    "us": 1e-6,
    "µs": 1e-6,
    "ms": 1e-3,
    "s": 1.0,
    "m": 60.0,
    "h": 3600.0,
}


def parse_duration(text: str) -> float:
    """Parse a Go-style duration ('5s', '1m30s', '500ms') into seconds.

    Bare numbers are accepted as seconds for convenience.
    """
    text = text.strip()
    if not text:
        raise ValueError("empty duration")
    try:
        return float(text)
    except ValueError:
        pass
    pos, total = 0, 0.0
    for m in _DURATION_RE.finditer(text):
        if m.start() != pos:
            raise ValueError(f"invalid duration: {text!r}")
        total += float(m.group(1)) * _DURATION_UNITS[m.group(2)]
        pos = m.end()
    if pos != len(text):
        raise ValueError(f"invalid duration: {text!r}")
    return total


@dataclass
class Config:
    server_address: str = ""
    timeout: float = 5.0       # seconds (default: config.go Load())
    log_level: str = "info"
    environment: str = "development"
    detected_runtime: RuntimeEnvironment = field(default=RuntimeEnvironment.LOCAL)


class ConfigLoader:
    def __init__(self, detector: Optional[RuntimeDetector] = None):
        self.detector = detector or RuntimeDetector()

    def load(self, argv: Optional[Sequence[str]] = None) -> Config:
        config = Config()
        self._load_from_flags(config, argv)
        self._load_from_env(config)
        config.detected_runtime = self.detector.detect_runtime()
        if not config.server_address:
            config.server_address = self._detect_server_address(
                config.detected_runtime
            )
        return config

    def _load_from_flags(self, config: Config, argv) -> None:
        parser = argparse.ArgumentParser(add_help=False)
        parser.add_argument("-server", "--server", default="")
        parser.add_argument("-timeout", "--timeout", default=None)
        parser.add_argument("-log-level", "--log-level", dest="log_level", default=None)
        parser.add_argument("-env", "--env", default=None)
        args, _ = parser.parse_known_args(argv)
        if args.server:
            config.server_address = args.server
        if args.timeout is not None:
            try:
                config.timeout = parse_duration(args.timeout)
            except ValueError as e:
                # Go's flag.DurationVar exits with a usage message on a bad
                # value; a raw traceback here would be the un-parity.
                raise SystemExit(f"invalid value for -timeout: {e}")
        if args.log_level is not None:
            config.log_level = args.log_level
        if args.env is not None:
            config.environment = args.env

    def _load_from_env(self, config: Config) -> None:
        if addr := os.environ.get("POLYKEY_SERVER_ADDR"):
            config.server_address = addr
        if timeout := os.environ.get("POLYKEY_TIMEOUT"):
            try:
                config.timeout = parse_duration(timeout)
            except ValueError:
                pass  # malformed env value keeps the prior setting, as in Go
        if level := os.environ.get("POLYKEY_LOG_LEVEL"):
            config.log_level = level
        if env := os.environ.get("POLYKEY_ENV"):
            config.environment = env

    @staticmethod
    def _detect_server_address(runtime: RuntimeEnvironment) -> str:
        if runtime is RuntimeEnvironment.KUBERNETES:
            return "polykey-service:50051"
        if runtime in (
            RuntimeEnvironment.DOCKER,
            RuntimeEnvironment.CONTAINERD,
            RuntimeEnvironment.PODMAN,
        ):
            return "polykey-server:50051"
        return "localhost:50051"


class NetworkTester:
    """Raw TCP reachability probe before the gRPC dial (config.go
    TestConnection: 3s dial timeout)."""

    def test_connection(self, address: str, timeout: float = 3.0) -> None:
        host, _, port = address.rpartition(":")
        if not host:
            raise ValueError(f"address missing port: {address!r}")
        host = host.strip("[]")  # bracketed IPv6 literals ([::1]:50051)
        try:
            with socket.create_connection((host, int(port)), timeout=timeout):
                pass
        except OSError as e:
            raise ConnectionError(f"failed to connect to {address}: {e}") from e
