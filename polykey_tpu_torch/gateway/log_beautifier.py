"""Stdin pipe entry point for the server-log beautifier:

    docker compose logs -f | python -m polykey_tpu_torch.gateway.log_beautifier
"""

from .beautify import beautify_server_stream

if __name__ == "__main__":
    beautify_server_stream()
