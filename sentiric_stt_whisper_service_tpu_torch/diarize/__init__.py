from .cluster import SpeakerClusterer, cosine_similarity  # noqa: F401
