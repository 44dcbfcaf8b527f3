"""Image URLs and the attention overlay."""
