"""The port's roofline on an H100 (``analysis``) and its report (``report``)."""
