"""UNet trunk, uncertainty heads and their assembly."""
