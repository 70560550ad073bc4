"""Container encode on the card (headers and serializers from gecoz_tpu)."""
