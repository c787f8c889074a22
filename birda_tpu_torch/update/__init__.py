from .mod import (
    UpdateInfo,
    check_for_update,
    is_dev_build,
    parse_semver,
    perform_update,
    platform_asset_key,
    replace_binary,
)

__all__ = [
    "UpdateInfo", "check_for_update", "is_dev_build", "parse_semver",
    "perform_update", "platform_asset_key", "replace_binary",
]
