"""Smart help display (reference ``src/cli/help.rs``).

The message depends on configuration state: a first-time user gets the setup
guide; a configured user gets a usage reminder.
"""

from __future__ import annotations

from ..config.types import Config

FIRST_TIME_HELP = """No models configured. Get started with Birda:

Quick setup (recommended):
   birda models list-available         # Browse available models
   birda models install birdnet-v24    # Install BirdNET v2.4

Or configure manually:
1. Initialize configuration:
   birda config init

2. Browse and install a model:
   birda models list-available
   birda models info birdnet-v24
   birda models install birdnet-v24 --default

3. Analyze audio files:
   birda recording.wav

Run 'birda -h' for all options."""

CONFIGURED_HELP = """Usage: birda [FILES]... [OPTIONS]

Example: birda recording.wav -m birdnet --min-confidence 0.25

Run 'birda -h' for all options or 'birda models list' to see configured models."""


def smart_help(config: Config) -> str:
    return FIRST_TIME_HELP if not config.models else CONFIGURED_HELP


def print_smart_help(config: Config) -> None:
    print(smart_help(config))
