"""The four halo-exchange benchmark twins (see ``halo_common.py``)."""
