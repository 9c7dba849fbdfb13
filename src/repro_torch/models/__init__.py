"""The LM substrate's models (``transformer``, ``attention``, ``moe``,
``ssm``, ``rglru``, ``common``) and the converter from and to the
reference's parameter trees (``convert``)."""
